"""The CUDA kernels of the port against their plain PyTorch twins, on the card.

Imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python3 -m pytest --noconftest tests/test_torch_cuda.py``
(the suite's ``conftest.py`` imports jax). Without a CUDA device every test
skips: a hand-written CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (K5_EDGES, ROUND4_EDGES, SEL_NAMES, SEL_STATICS,
                        admm_iterations_case, admm_iterations_edge_case, descent_lps,
                        gram_case, random_qps, round4_case, round4_edge_case,
                        selection_case, selection_lattice_case)
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
@pytest.mark.parametrize("problem", ["random36", "random48", "descent36", "random2142",
                                     "B1000_2142", "B1000_3264", "B1000_510",
                                     "B1000_12"])
def test_kernel_matches_twin(cuda, problem, dtype, tol):
    """K1 against its twin. The warp-per-lane instance also at its edges:
    two constraint rows a thread (m > 32), the largest shape, nv = 1, and
    B = 1000, not a multiple of the four lanes in a block."""
    arrays = {"random36": lambda: random_qps(1024, 3, 6, 0),
              "random48": lambda: random_qps(1024, 4, 8, 1),
              "descent36": lambda: descent_lps(1024, 2),
              # the descent LP's shape on the 20-variable ZDT path
              "random2142": lambda: random_qps(1024, 21, 42, 2),
              "B1000_2142": lambda: random_qps(1000, 21, 42, 24),
              "B1000_3264": lambda: random_qps(1000, 32, 64, 35),
              "B1000_510": lambda: random_qps(1000, 5, 10, 8),
              "B1000_12": lambda: random_qps(1000, 1, 2, 4)}[problem]()
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,cap,kind", [(2, 157, "random"), (3, 1507, "random"),
                                        (20, 5332, "random"), (20, 1200, "lattice"),
                                        (32, 600, "lattice")])
def test_selection_kernel_matches_twin(cuda, n, cap, kind, dtype):
    """K2 (rounds 1-3) against its twin: every output equal on every lane,
    floats to the bit (both round every operation alike and sum in the same
    order). The lattice cases tie exactly, with duplicate rows cap/2 apart
    that fall to different threads and warps of the block instance, empty
    lanes and counts past the capacity."""
    from morbit_tpu_torch.ops import prepare_fused
    from morbit_tpu_torch.ops.prepare_coord import rbf_selection_core

    make = selection_case if kind == "random" else selection_lattice_case
    case = make(np.random.default_rng(n + cap), 1024, cap, n, "mixed")
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    i = lambda a: torch.as_tensor(a, dtype=torch.int32, device=cuda)
    X, count, x_s, x_index, delta, lb, ub, max_new, efl = case
    args = (f(X), i(count), f(x_s), i(x_index), f(delta), f(lb), f(ub), i(max_new),
            torch.as_tensor(efl, device=cuda))
    before = prepare_fused.selection_launches
    k = prepare_fused.selection(*args, **SEL_STATICS)
    t = rbf_selection_core(*args, **SEL_STATICS)
    torch.cuda.synchronize()
    assert prepare_fused.selection_launches == before + 1
    for name, a, b in zip(SEL_NAMES, k, t):
        if a.is_floating_point():
            assert bool(((a == b) | (a.isnan() & b.isnan())).all()), name
        else:
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel,deg", [("multiquadric", 1), ("cubic", 1),
                                        ("multiquadric", 0)])
def test_round4_kernel_matches_twin(cuda, kernel, deg, dtype):
    """K3 (round 4) against its twin: the same acceptances on every lane,
    with rejections present."""
    from morbit_tpu_torch.models.rbf_round4 import run_round4
    from morbit_tpu_torch.ops import prepare_fused

    X, cand, init, count, param = round4_case(np.random.default_rng(11), 1024, 60,
                                              2, 6, 0.4)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    args = (f(X), torch.as_tensor(cand, device=cuda), f(init),
            torch.as_tensor(count, dtype=torch.int32, device=cuda))
    kw = dict(kernel=kernel, param=3 if kernel == "cubic" else f(param),
              poly_deg=deg, max_points=6, chol_pivot=0.3 if deg == 0 else 0.1)
    before = prepare_fused.round4_launches
    acc_k, N_k = prepare_fused.round4(*args, **kw)
    acc_t, N_t = run_round4(*args, **kw)
    torch.cuda.synchronize()
    assert prepare_fused.round4_launches == before + 1
    assert torch.equal(N_k, N_t) and torch.equal(acc_k, acc_t)
    assert int(N_t.min()) < 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["cubic", "multiquadric"])
def test_round4_wide_kernel_matches_twin(cuda, kernel, dtype):
    """K3's block-per-lane instance at the shapes of the 20-variable ZDT path
    (max_points 231, a 251-row training buffer, 2310 candidates) against its
    twin: the same acceptances on every lane, rejections present."""
    from morbit_tpu_torch.models.rbf_round4 import run_round4
    from morbit_tpu_torch.ops import prepare_fused

    X, cand, init, count, param = round4_case(np.random.default_rng(12), 64, 2310,
                                              20, 231, 0.4, width=251)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    args = (f(X), torch.as_tensor(cand, device=cuda), f(init),
            torch.as_tensor(count, dtype=torch.int32, device=cuda))
    kw = dict(kernel=kernel, param=3 if kernel == "cubic" else f(param), poly_deg=1,
              max_points=231, chol_pivot=0.1)
    before = prepare_fused.round4_launches
    acc_k, N_k = prepare_fused.round4(*args, **kw)
    acc_t, N_t = run_round4(*args, **kw)
    torch.cuda.synchronize()
    assert prepare_fused.round4_launches == before + 1
    assert torch.equal(N_k, N_t) and torch.equal(acc_k, acc_t)
    tested = args[1] & (torch.cumsum(acc_t.int(), -1) < 231 - args[3][:, None])
    assert bool((tested & ~acc_t).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ROUND4_EDGES)
def test_round4_wide_kernel_edges_match_twin(cuda, kind, dtype):
    """K3's block-per-lane instance at its edges (``round4_edge_case``:
    counts below pd, no site yet, lanes already full, lanes that fill to
    max_points, lanes with no candidate) against its twin, lane by lane."""
    from morbit_tpu_torch.models.rbf_round4 import run_round4
    from morbit_tpu_torch.ops import prepare_fused

    X, cand, init, count, _ = round4_edge_case(np.random.default_rng(7), 64, kind)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    args = (f(X), torch.as_tensor(cand, device=cuda), f(init),
            torch.as_tensor(count, dtype=torch.int32, device=cuda))
    kw = dict(kernel="cubic", param=3, poly_deg=1, max_points=231, chol_pivot=1e-14)
    before = prepare_fused.round4_launches
    acc_k, N_k = prepare_fused.round4(*args, **kw)
    acc_t, N_t = run_round4(*args, **kw)
    torch.cuda.synchronize()
    assert prepare_fused.round4_launches == before + 1
    assert torch.equal(N_k, N_t) and torch.equal(acc_k, acc_t)
    if kind == "fill_to_max":
        assert int(N_t.max()) == 231


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("kernel", ["cubic", "multiquadric", "inv_multiquadric",
                                    "gaussian", "thin_plate_spline"])
def test_gram_kernel_matches_twin(cuda, kernel, dtype, tol):
    """K4 at the wide path's shape (P=251, n=20) against its twin, within
    tol * max|Phi| (the two sum the cross term in different orders)."""
    from morbit_tpu_torch.ops import dense_kernels
    from morbit_tpu_torch.ops.rbf import EXPONENT_KERNELS, kernel_default_param

    sites, mask, param = gram_case(np.random.default_rng(5), 64, 251, 20)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    par = kernel_default_param(kernel) if kernel in EXPONENT_KERNELS else f(param)
    args = (f(sites), torch.as_tensor(mask, device=cuda), kernel, par)
    before = dense_kernels.gram_launches
    k = dense_kernels.rbf_gram_matrix(*args)
    t = dense_kernels.rbf_gram_matrix_plain(*args)
    torch.cuda.synchronize()
    assert dense_kernels.gram_launches == before + 1
    assert float((k - t).abs().max()) <= tol * float(t.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("P,n,kernel", [(128, 1, "cubic"), (129, 20, "gaussian"),
                                        (251, 32, "thin_plate_spline"),
                                        (512, 20, "multiquadric"),
                                        (129, 32, "inv_multiquadric")])
def test_gram_kernel_edges_match_twin(cuda, P, n, kernel, dtype, tol):
    """K4 at the edges of its tiling (P a multiple of 32 and one past it,
    n = 1 and n = 32) against its twin within tol * max|Phi|, and exactly
    symmetric (only the tiles with I <= J are computed)."""
    from morbit_tpu_torch.ops import dense_kernels
    from morbit_tpu_torch.ops.rbf import EXPONENT_KERNELS, kernel_default_param

    sites, mask, param = gram_case(np.random.default_rng(P + n), 16, P, n)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    par = kernel_default_param(kernel) if kernel in EXPONENT_KERNELS else f(param)
    args = (f(sites), torch.as_tensor(mask, device=cuda), kernel, par)
    k = dense_kernels.rbf_gram_matrix(*args)
    t = dense_kernels.rbf_gram_matrix_plain(*args)
    torch.cuda.synchronize()
    assert float((k - t).abs().max()) <= tol * float(t.abs().max())
    assert torch.equal(k, k.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("n,m", [(3, 6), (21, 42)])
def test_admm_iterations_kernel_matches_twin(cuda, n, m, dtype, tol):
    """K5 against its twin, 100 steps, within tol * max(1, max|twin|)."""
    from morbit_tpu_torch.ops import dense_kernels

    args = [torch.as_tensor(a, dtype=dtype, device=cuda)
            for a in admm_iterations_case(1024, n, m, seed=n)]
    kw = dict(iters=100, sigma=1e-6, alpha=1.6)
    before = dense_kernels.admm_iterations_launches
    k = dense_kernels.admm_iterations(*args, **kw)
    t = dense_kernels.admm_iterations_plain(*args, **kw)
    torch.cuda.synchronize()
    assert dense_kernels.admm_iterations_launches == before + 1
    for a, b in zip(k, t):
        assert float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("edge", K5_EDGES, ids=[e[0] for e in K5_EDGES])
def test_admm_iterations_kernel_edges_match_twin(cuda, edge, dtype, tol):
    """K5 on its edge sets (``chip_smoke.K5_EDGES``: (1, 1), (32, 64),
    (64, 128), B=1, B not a multiple of the instances a block, no steps,
    rows with infinite bounds) against its twin within tol * max(1,
    max|twin|); with no steps the outputs are the inputs."""
    from morbit_tpu_torch.ops import dense_kernels

    _, n, m, B, iters, inf_rows = edge
    args = [torch.as_tensor(a, dtype=dtype, device=cuda)
            for a in admm_iterations_edge_case(B, n, m, inf_rows, seed=n)]
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    k = dense_kernels.admm_iterations(*args, **kw)
    t = dense_kernels.admm_iterations_plain(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(k, t):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))
    if iters == 0:
        assert all(torch.equal(a, b) for a, b in zip(k, args[6:]))
