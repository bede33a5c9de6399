"""The CUDA kernel of the port against its plain PyTorch twin, on the card.

Imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python3 -m pytest --noconftest tests/test_torch_cuda.py``
(the suite's ``conftest.py`` imports jax). Without a CUDA device every test
skips: a hand-written CUDA kernel has no CPU mode.
"""

import pytest
import torch

from chip_smoke import descent_lps, random_qps
from morbit_tpu_torch.ops import qp_lane
from morbit_tpu_torch.ops.qp import _rho_vec


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 2e-3)])
@pytest.mark.parametrize("problem", ["random36", "random48", "descent36"])
def test_kernel_matches_twin(cuda, problem, dtype, tol):
    arrays = {"random36": lambda: random_qps(1024, 3, 6, 0),
              "random48": lambda: random_qps(1024, 4, 8, 1),
              "descent36": lambda: descent_lps(1024, 2)}[problem]()
    P, q, A, lo, hi = (torch.as_tensor(a, dtype=dtype, device=cuda)
                       for a in arrays)
    r = A.abs().amax(-1)
    A, lo, hi = (A / r[..., None]).contiguous(), lo / r, hi / r
    f32 = dtype == torch.float32
    kw = dict(n_stages=4, n_steps=100, sigma=1e-4 if f32 else 1e-6, alpha=1.6,
              rho_lo=1e-3 if f32 else 1e-6, rho_hi=1e4 if f32 else 1e6)
    rho0 = _rho_vec(lo, hi, 0.1)
    before = qp_lane.launches
    zk, _, _ = qp_lane.admm_stages(P, q, A, lo, hi, rho0, **kw)
    zp, _, _ = qp_lane.admm_stages_plain(P, q, A, lo, hi, rho0, **kw)
    torch.cuda.synchronize()
    assert qp_lane.launches == before + 1
    torch.testing.assert_close(zk, zp, rtol=0, atol=tol)


@pytest.mark.cuda
def test_kernel_rejects_cpu_mix(cuda):
    P, q, A, lo, hi = (torch.as_tensor(a, device=cuda)
                       for a in random_qps(4, 3, 6, 0))
    with pytest.raises(ValueError, match="cuda"):
        qp_lane.admm_stages_cuda(P, q.cpu(), A, lo, hi, _rho_vec(lo, hi, 0.1),
                                 n_stages=1, n_steps=1, sigma=1e-6, alpha=1.6,
                                 rho_lo=1e-6, rho_hi=1e6)
