"""The CUDA kernels of the port against their plain PyTorch twins, on the card.

Imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python3 -m pytest --noconftest tests/test_torch_cuda.py``
(the suite's ``conftest.py`` imports jax). Without a CUDA device every test
skips: a hand-written CUDA kernel has no CPU mode.
"""

import unittest.mock

import numpy as np
import pytest
import torch

from chip_smoke import (K5_EDGES, ROUND4_EDGES, SEL_NAMES, SEL_STATICS,
                        admm_iterations_case, admm_iterations_edge_case,
                        constrained_lps, descent_lps, gram_case, lane_limits, random_qps,
                        round4_case, round4_edge_case, selection_case,
                        selection_lattice_case)
from morbit_tpu_torch.ops import qp_lane
from morbit_tpu_torch.ops.qp import _rho_vec
from morbit_tpu_torch.tools.width_gaps import FIT_K, FIT_M, POLISH_K, PRODUCT_M


#: K1's shapes past its warp instance: ZDT1's steepest-descent LP (nv = n+1,
#: m = 2n + 2) at n = 32, 50, 64, 80 and at n = 30 with three linear rows
WIDE_LPS = {"wide3165": (31, 65), "wide3366": (33, 66), "wide51102": (51, 102),
            "wide65130": (65, 130), "wide81162": (81, 162)}


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
                                     "B1000_12", "descent38", "descent38_eq",
                                     "normal411", "normal411_eq", *WIDE_LPS])
def test_kernel_matches_twin(cuda, problem, dtype, tol):
    """K1 against its twin. The warp-per-lane instance also at its edges:
    two constraint rows a thread (m > 32), the largest shape, nv = 1, and
    B = 1000, not a multiple of the four lanes in a block; and at the
    constrained path's LPs: the descent LP with constraint rows (3, 8) and
    the normal-step LP (4, 11), each also with an equality row. The strided
    instance at ``WIDE_LPS``, B = 16: the shapes past the warp instance
    of ZDT1 at n = 30 with three linear rows (31, 65), at n = 32 (33, 66),
    n = 50 (51, 102), n = 64 (65, 130) and n = 80 (81, 162, its stage
    matrices in the workspace at float64), each lane within ``lane_limits``."""
    arrays = {"random36": lambda: random_qps(1024, 3, 6, 0),
              "random48": lambda: random_qps(1024, 4, 8, 1),
              "descent36": lambda: descent_lps(1024, 2),
              # the descent LP's shape on the 20-variable ZDT path
              "random2142": lambda: random_qps(1024, 21, 42, 2),
              "B1000_2142": lambda: random_qps(1000, 21, 42, 24),
              "B1000_3264": lambda: random_qps(1000, 32, 64, 35),
              "B1000_510": lambda: random_qps(1000, 5, 10, 8),
              "B1000_12": lambda: random_qps(1000, 1, 2, 4),
              "descent38": lambda: constrained_lps(1024, "descent_con", 40),
              "descent38_eq": lambda: constrained_lps(1024, "descent_con_eq", 41),
              "normal411": lambda: constrained_lps(1024, "normal", 42),
              "normal411_eq": lambda: constrained_lps(1024, "normal_eq", 43),
              **{k: lambda k=k: random_qps(16, *WIDE_LPS[k], 60 + WIDE_LPS[k][0])
                 for k in WIDE_LPS}}[problem]()
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
    if problem.startswith(("descent38", "normal411", "wide")):
        # LPs whose unconverged lanes amplify rounding: each lane held, as
        # in chip_smoke.py kernel_admm, to ten times its own one-ulp
        # sensitivity where that exceeds the fixed tolerance
        limit = lane_limits(tol, lambda A1: qp_lane.admm_stages_plain(
            P, q, A1, lo, hi, rho0, **kw)[0], A, zp)
        dz = (zk - zp).abs().amax(-1)
        assert not (dz > limit).any(), (dz[dz > limit], limit[dz > limit])
    else:
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
                                        (32, 600, "lattice"), (2, 22, "random"),
                                        (2, 64, "random")])
def test_selection_kernel_matches_twin(cuda, n, cap, kind, dtype):
    """K2 (rounds 1-3) against its twin: every output equal on every lane,
    floats to the bit (both round every operation alike and sum in the same
    order). The lattice cases tie exactly, with duplicate rows cap/2 apart
    that fall to different threads and warps of the block instance, empty
    lanes and counts past the capacity. Capacities 22 and 64 are the staged
    main path's first stage and its probe-tuned capacity."""
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
@pytest.mark.parametrize("n,cap,kind", [(33, 600, "random"), (50, 1000, "random"),
                                        (50, 600, "lattice"), (64, 300, "random")])
def test_selection_wide_kernel_matches_twin(cuda, n, cap, kind, dtype):
    """K2's wide instance (n > 32; at n = 64 float64 its matrices in the
    workspace) against its twin at B = 16: every output equal on every
    lane, floats to the bit, as for the block instance."""
    from morbit_tpu_torch.ops import prepare_fused
    from morbit_tpu_torch.ops.prepare_coord import rbf_selection_core

    make = selection_case if kind == "random" else selection_lattice_case
    case = make(np.random.default_rng(n + cap), 16, cap, n, "mixed")
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    i = lambda a: torch.as_tensor(a, dtype=torch.int32, device=cuda)
    X, count, x_s, x_index, delta, lb, ub, max_new, efl = case
    args = (f(X), i(count), f(x_s), i(x_index), f(delta), f(lb), f(ub), i(max_new),
            torch.as_tensor(efl, device=cuda))
    assert prepare_fused.selection_plan(n, torch.finfo(dtype).bits // 8).instance == "wide"
    before = prepare_fused.selection_launches
    k = prepare_fused.selection(*args, **SEL_STATICS)
    t = rbf_selection_core(*args, **SEL_STATICS)
    torch.cuda.synchronize()
    assert prepare_fused.selection_launches == before + 1
    if kind == "random":
        assert int(t[1].max()) > 1     # lanes pick more than one site
    for name, a, b in zip(SEL_NAMES, k, t):
        if a.is_floating_point():
            assert bool(((a == b) | (a.isnan() & b.isnan())).all()), name
        else:
            assert torch.equal(a, b), name


#: K3's shapes past its block instance (max_points, n, candidate columns):
#: the default RBF's max_points (n+1)(n+2)/2 at n = 32 and n = 50,
#: ``max_model_points=600`` at n = 10, pd > max_points at n = 50, and
#: n = 120 (its shared vectors in the workspace at float64)
ROUND4_SLOT_CASES = ((561, 32, 300), (1326, 50, 200), (600, 10, 300), (40, 50, 200),
                     (200, 120, 150))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("maxN,n,C", ROUND4_SLOT_CASES)
def test_round4_slots_kernel_matches_twin(cuda, maxN, n, C, dtype):
    """K3's slot instance against its twin at B = 8, the lanes looped over
    three slots (``slots=3``) and on the card's resident blocks (a slot a
    lane): the same acceptances on every lane, rejections present; and the
    wrapper's plan sizes a slot as the source does."""
    from morbit_tpu_torch.models.rbf_round4 import run_round4
    from morbit_tpu_torch.ops import prepare_fused

    item = torch.finfo(dtype).bits // 8
    plan = prepare_fused.round4_plan(maxN, n, n + 1, item)
    assert plan.instance == "slots"
    lib = prepare_fused._library(prepare_fused.ROUND4_SOURCE)
    assert plan.work_elems == lib.rbf_round4_slot_lane_elems(maxN, n, n + 1, plan.place)
    X, cand, init, count, _ = round4_case(np.random.default_rng(maxN + n), 8, C, n,
                                          maxN, 0.2, width=maxN + n)
    count = np.minimum(count, np.random.default_rng(n).integers(1, 3 * n, 8)).astype(np.int32)
    init = np.where((np.arange(maxN + n)[None, :] < count[:, None])[..., None], init, 0.0)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    args = (f(X), torch.as_tensor(cand, device=cuda), f(init),
            torch.as_tensor(count, dtype=torch.int32, device=cuda))
    kw = dict(kernel="cubic", param=3, poly_deg=1, max_points=maxN, chol_pivot=1e-7)
    before = prepare_fused.round4_launches
    acc_k, N_k = prepare_fused.round4_cuda(*args, **kw, slots=3)
    acc_r, N_r = prepare_fused.round4_cuda(*args, **kw)   # a slot a lane
    acc_t, N_t = run_round4(*args, **kw)
    torch.cuda.synchronize()
    assert prepare_fused.round4_launches == before + 2
    assert torch.equal(N_k, N_t) and torch.equal(acc_k, acc_t)
    assert torch.equal(N_r, N_t) and torch.equal(acc_r, acc_t)
    assert int(acc_t.sum()) > 0
    tested = args[1] & (torch.cumsum(acc_t.int(), -1) < maxN - args[3][:, None])
    assert bool((tested & ~acc_t).any())


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
def test_round4_launch_releases_cached_memory(cuda):
    """A K3 launch whose local memory the driver cannot reserve while
    PyTorch's cache holds the card's free memory runs once the wrapper has
    released the cache: the float64 thread instance (a stack frame of ~30 KB
    a thread, ~8 GB for the card) with all but 1 GiB of the card cached.
    (Where an earlier launch in the process reserved that memory already,
    the first launch succeeds.)"""
    from morbit_tpu_torch.models.rbf_round4 import run_round4
    from morbit_tpu_torch.ops import prepare_fused

    free, _ = torch.cuda.mem_get_info()
    held = torch.empty((max(free - (1 << 30), 0),), dtype=torch.uint8, device=cuda)
    del held                       # back in PyTorch's cache, not freed
    X, cand, init, count, param = round4_case(np.random.default_rng(11), 1024, 60,
                                              2, 6, 0.4)
    f = lambda a: torch.as_tensor(a, dtype=torch.float64, device=cuda)
    args = (f(X), torch.as_tensor(cand, device=cuda), f(init),
            torch.as_tensor(count, dtype=torch.int32, device=cuda))
    kw = dict(kernel="multiquadric", param=f(param), poly_deg=0, max_points=6,
              chol_pivot=0.3)
    acc_k, N_k = prepare_fused.round4_cuda(*args, **kw)
    acc_t, N_t = run_round4(*args, **kw)
    assert torch.equal(N_k, N_t) and torch.equal(acc_k, acc_t)


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
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("P,n,kernel", [(1326, 50, "cubic"), (1081, 45, "cubic"),
                                        (1081, 45, "gaussian")])
def test_gram_tiled_kernel_matches_twin(cuda, P, n, kernel, dtype, tol):
    """K4's tiled instance (a lane's sites past a block's shared memory:
    the fits of ZDT1 at n = 50 and n = 45) against its twin at B = 4 within
    tol * max|Phi|, exactly symmetric, and equal to the bit to the staged
    instance on the sites' leading 256 rows where both take them."""
    from morbit_tpu_torch.ops import dense_kernels
    from morbit_tpu_torch.ops.rbf import EXPONENT_KERNELS, kernel_default_param

    item = torch.finfo(dtype).bits // 8
    assert dense_kernels.gram_plan(P, n, item).instance == "tiled"
    sites, mask, param = gram_case(np.random.default_rng(P + n), 4, P, n)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    par = kernel_default_param(kernel) if kernel in EXPONENT_KERNELS else f(param)
    args = (f(sites), torch.as_tensor(mask, device=cuda), kernel, par)
    before = dense_kernels.gram_launches
    k = dense_kernels.rbf_gram_matrix(*args)
    t = dense_kernels.rbf_gram_matrix_plain(*args)
    torch.cuda.synchronize()
    assert dense_kernels.gram_launches == before + 1
    assert float((k - t).abs().max()) <= tol * float(t.abs().max())
    assert torch.equal(k, k.transpose(1, 2))
    head = (args[0][:, :256].contiguous(), args[1][:, :256].contiguous(), kernel, par)
    with unittest.mock.patch.object(dense_kernels.cuda_build, "SMEM_LIMIT", 0):
        tiled = dense_kernels.rbf_gram_matrix(*head)
    assert dense_kernels.gram_plan(256, n, item).instance == "staged"
    assert torch.equal(tiled, dense_kernels.rbf_gram_matrix(*head))


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


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["starving_widths", "tuned_capacity"])
def test_staged_matches_plain_on_card(cuda, variant):
    """The staged runner on the card at float64, B=16 Halton starts of the
    main path, max_iter=100, against the plain runner lane by lane
    (``chip_smoke.compare_staged``: integers exact, floats within 1e-9 +
    1e-6 |x|): a width of 1 in the second stage, and the probe-tuned
    capacity, schedule and widths."""
    from chip_smoke import LB, QP_ITERS, UB, compare_staged, rbf_mop
    from morbit_tpu_torch import AlgorithmConfig, StagedMultistart, multistart_optimize
    from morbit_tpu_torch.bench import tuned_runner
    from morbit_tpu_torch.parallel.multistart import capacity_overflowed
    from morbit_tpu_torch.problems.synthetic import halton_starts

    ac = AlgorithmConfig(max_iter=100, qp_iters=QP_ITERS)
    x0 = torch.as_tensor(halton_starts(16, LB, UB), dtype=torch.float64, device=cuda)
    ref = multistart_optimize(rbf_mop(), x0, ac, dtype=torch.float64)
    if variant == "starving_widths":
        run = StagedMultistart(rbf_mop(), ac, torch.float64, schedule=(3, 6), widths=(16, 1))
    else:
        run, _ = tuned_runner(rbf_mop(), ac, torch.float64, cuda, x0)
        assert run.solver.db_capacity < 1507
    res = run(x0)
    assert not capacity_overflowed(res)
    compare_staged(res, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["taylor", "lagrange", "ps"])
def test_family_card_matches_cpu(cuda, kind):
    """The Taylor, Lagrange and Pascoletti-Serafini paths of
    ``chip_smoke.FAMILY_KINDS`` at float64, B=4 Halton starts, max_iter=6:
    every trip on the card from the CPU's state equals the CPU's trip
    (``chip_smoke.lockstep``: integers exact, floats within 1e-9 +
    1e-6 |x|), and no lane parts."""
    from chip_smoke import LB, QP_ITERS, UB, family_config, family_mop, lockstep
    from morbit_tpu_torch.problems.synthetic import halton_starts

    ac = family_config(kind, max_iter=6, qp_iters=QP_ITERS)
    trips, _, _, parted, _ = lockstep(lambda: family_mop(kind), halton_starts(4, LB, UB), ac)
    assert trips >= 6 and parted == []


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["composite", "scaler_model", "no_db", "host", "exit_eps",
                                  "max_points"])
def test_option_card_matches_cpu(cuda, kind):
    """The composite, 'model'-scaler, no-database, host-function, QP-exit
    and ``use_max_points`` paths of ``chip_smoke.OPTION_KINDS`` at
    float64, B=4 Halton starts, max_iter=6:
    every trip on the card from the CPU's state equals the CPU's trip
    (``chip_smoke.lockstep``), and no lane parts."""
    from chip_smoke import LB, QP_ITERS, UB, family_config, family_mop, lockstep
    from morbit_tpu_torch.problems.synthetic import halton_starts

    ac = family_config(kind, max_iter=6, qp_iters=QP_ITERS)
    trips, _, _, parted, _ = lockstep(lambda: family_mop(kind), halton_starts(4, LB, UB), ac)
    assert trips >= 6 and parted == []


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 2e-3)])
@pytest.mark.parametrize("problem", ["random36", "random48", "descent36", "B1000_2142",
                                     *WIDE_LPS])
def test_exit_kernel_matches_twin(cuda, problem, dtype, tol):
    """K1's exit instance (``exit_eps`` 1e-5) against its twin: each lane
    runs the twin's count of stages unless the twin's own decision moves
    when A moves by ten ulps (``chip_smoke.ten_ulps``) or, at float32, the
    tolerance lies between the two implementations' own residuals where
    they part (``chip_smoke.exit_straddles``), and z is within the
    larger of the fixed tolerance and ten times the lane's own one-ulp
    sensitivity; below every residual the exit instance equals the
    fixed-trip instance to the bit."""
    from chip_smoke import ULP_PROBES, exit_straddles, ten_ulps

    arrays = {"random36": lambda: random_qps(1024, 3, 6, 0),
              "random48": lambda: random_qps(1024, 4, 8, 1),
              "descent36": lambda: descent_lps(1024, 2),
              "B1000_2142": lambda: random_qps(1000, 21, 42, 24),
              **{k: lambda k=k: random_qps(16, *WIDE_LPS[k], 60 + WIDE_LPS[k][0])
                 for k in WIDE_LPS}}[problem]()
    P, q, A, lo, hi = (torch.as_tensor(a, dtype=dtype, device=cuda) for a in arrays)
    r = A.abs().amax(-1)
    A, lo, hi = (A / r[..., None]).contiguous(), lo / r, hi / r
    f32 = dtype == torch.float32
    kw = dict(n_stages=4, n_steps=100, sigma=1e-4 if f32 else 1e-6, alpha=1.6,
              rho_lo=1e-3 if f32 else 1e-6, rho_hi=1e4 if f32 else 1e6)
    rho0 = _rho_vec(lo, hi, 0.1)
    twin = lambda A1: qp_lane.admm_stages_exit_plain(P, q, A1, lo, hi, rho0, exit_eps=1e-5,
                                                     **kw)
    z, _, _, stages = qp_lane.admm_stages_exit_cuda(P, q, A, lo, hi, rho0, exit_eps=1e-5,
                                                    **kw)
    zt, _, _, st = twin(A)
    sensitive = torch.zeros_like(st, dtype=torch.bool)
    for seed in ULP_PROBES:
        sensitive |= twin(ten_ulps(A, seed))[3] != st
    parted = stages != st
    straddle, residuals = torch.zeros_like(parted), []
    if f32:   # each implementation stops on its own residual
        kw_e = dict(kw, exit_eps=1e-5)
        straddle = exit_straddles((P, q, A, lo, hi, rho0), kw_e, stages.cpu(), st.cpu(),
                                  (parted & ~sensitive).cpu(), residuals).to(cuda)
    assert not (parted & ~sensitive & ~straddle).any(), residuals
    limit = lane_limits(tol, lambda A1: twin(A1)[0], A, zt)
    dz = (z - zt).abs().amax(-1)
    assert not ((dz > limit) & ~parted).any()
    full = qp_lane.admm_stages_exit_cuda(P, q, A, lo, hi, rho0, exit_eps=1e-300, **kw)
    fixed = qp_lane.admm_stages_cuda(P, q, A, lo, hi, rho0, **kw)
    ran_all = full[3] == kw["n_stages"]
    assert ran_all.any()
    for got, want in zip(full, fixed):
        assert torch.equal(got[ran_all], want[ran_all])


@pytest.mark.cuda
@pytest.mark.parametrize("ladder,stage_iters", [((16, 8, 4, 2), 3), ((16, 12, 11, 10, 4), 2)])
def test_compacted_matches_plain_on_card(cuda, ladder, stage_iters):
    """The compacted runner on the card at float64, B=16 Halton starts of
    the main path, max_iter=12, qp_iters=100, against the plain runner on
    the card: every leaf of the state, integers exact and floats within
    1e-12 (the CPU test's ladders: (16, 8, 4, 2) never compacts these
    lanes, the other does)."""
    from chip_smoke import LB, UB, rbf_mop
    from morbit_tpu_torch import AlgorithmConfig, CompactedMultistart, multistart_optimize
    from morbit_tpu_torch.problems.synthetic import halton_starts
    from morbit_tpu_torch.utils.carry import state_to_numpy

    ac = AlgorithmConfig(max_iter=12, qp_iters=100)
    x0 = torch.as_tensor(halton_starts(16, LB, UB), dtype=torch.float64, device=cuda)
    ref = multistart_optimize(rbf_mop(), x0, ac, dtype=torch.float64)
    res = CompactedMultistart(rbf_mop(), ac, torch.float64, stage_iters=stage_iters,
                              bucket_ladder=ladder)(x0)
    a, b = state_to_numpy(res.state), state_to_numpy(ref.state)
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape, name
        if a[name].dtype.kind in "biu":
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        else:
            np.testing.assert_allclose(a[name], b[name], rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.cuda
def test_perform_test_on_card_matches_cpu(cuda):
    """``perform_test(device="cuda")`` on ``two_parabolas-n2-exact-steepest_descent-s3``
    (max_iter=6, qp_iters=100, float64) against the same on the CPU:
    integers exact, floats within 1e-10 (lane 1 within its bound in
    ``chip_smoke.GRID_MAY_PART``, 1e-9: its first LP's polish), and the
    keys of the JAX harness."""
    from chip_smoke import GRID_MAY_PART
    from morbit_tpu_torch.parallel.benchmarks import Setting, perform_test

    s = Setting("two_parabolas", 2, "exact", "steepest_descent", 3)
    card = perform_test(s, dtype=torch.float64, device="cuda", steady_state=True,
                        max_iter=6, qp_iters=100)
    cpu = perform_test(s, dtype=torch.float64, device="cpu", max_iter=6, qp_iters=100)
    assert set(card) == set(cpu) | {"steady_state_s", "steady_runs_per_sec",
                                    "compile_s_approx"}
    for k in ("n_evals", "n_iterations", "stop_code"):
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)
    for k in ("x", "fx", "omega"):
        lim = np.full(card[k].shape, 1e-10)
        for lane, (tol, _) in GRID_MAY_PART[s.key].items():
            lim[lane] = tol
        assert np.all(np.abs(card[k] - cpu[k]) <= lim), (k, np.abs(card[k] - cpu[k]))


@pytest.mark.cuda
def test_parametric_on_card_matches_cpu(cuda):
    """``parametric_multistart`` on ``build_shifted`` at float64, 4 lanes
    with their own centres, max_iter=8, qp_iters=100: the card's run
    against the CPU's, integers exact and floats within 1e-10, theta kept
    on the card as a leaf of the state."""
    from morbit_tpu_torch import AlgorithmConfig, parametric_multistart
    from morbit_tpu_torch.problems.synthetic import build_shifted, halton_starts

    thetas = np.random.default_rng(3).uniform(0.5, 2.5, (4, 2))
    x0 = halton_starts(4, [-4.0, -4.0], [4.0, 4.0])
    ac = AlgorithmConfig(max_iter=8, qp_iters=100)
    card = parametric_multistart(build_shifted, x0, thetas, ac, torch.float64)
    cpu = parametric_multistart(build_shifted, x0, thetas, ac, torch.float64, device="cpu")
    assert card.state.theta[0].is_cuda
    for k in ("stop_code", "n_iterations", "n_evals"):
        np.testing.assert_array_equal(getattr(card, k).cpu().numpy(),
                                      getattr(cpu, k).numpy(), err_msg=k)
    for k in ("x", "fx"):
        np.testing.assert_allclose(getattr(card, k).cpu().numpy(), getattr(cpu, k).numpy(),
                                   rtol=0, atol=1e-10, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("runner", ["plain", "staged_widths", "parametric"])
def test_mesh_on_card_matches_unsharded(cuda, runner):
    """The mesh form on the card at float64, 16 Halton starts of the main
    path, max_iter=12, qp_iters=100, a mesh of the card four times: the
    plain runner, ``StagedMultistart`` with widths (per shard) and
    ``parametric_multistart``, each equal to its unsharded run leaf by
    leaf: integers exact, every float leaf within 1e-12 (the trajectory
    column by column). The float64 solves and lane products go through K6
    and K7 on the card, whose bits do not depend on a shard's width
    (ROADMAP 3.15), so the staged runner's stages of 4 and 2 lanes a shard
    are held as tightly as the plain runner."""
    from chip_smoke import LB, UB, rbf_mop
    from morbit_tpu_torch import (AlgorithmConfig, StagedMultistart, multistart_optimize,
                                  parametric_multistart)
    from morbit_tpu_torch.parallel.multistart import canonicalize_buffer_tails
    from morbit_tpu_torch.problems.synthetic import build_shifted, halton_starts
    from morbit_tpu_torch.tools.width_gaps import leaf_gaps
    from morbit_tpu_torch.utils.carry import state_to_numpy

    ac = AlgorithmConfig(max_iter=12, qp_iters=100)
    x0 = torch.as_tensor(halton_starts(16, LB, UB), dtype=torch.float64, device=cuda)
    thetas = np.random.default_rng(4).uniform(0.5, 2.5, (16, 2))
    run = {"plain": lambda mesh: multistart_optimize(rbf_mop(), x0, ac, torch.float64,
                                                     mesh=mesh),
           "staged_widths": lambda mesh: StagedMultistart(
               rbf_mop(), ac, torch.float64, schedule=(3, 6), widths=(16, 8, 8),
               mesh=mesh)(x0),
           "parametric": lambda mesh: parametric_multistart(
               build_shifted, x0, thetas, ac, torch.float64, mesh=mesh)}[runner]
    res, ref = run(["cuda:0"] * 4), run(None)
    if runner == "staged_widths":
        ref = multistart_optimize(rbf_mop(), x0, ac, torch.float64)
    a = state_to_numpy(canonicalize_buffer_tails(res.state))
    b = state_to_numpy(canonicalize_buffer_tails(ref.state))
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape, name
    ints_equal, gaps = leaf_gaps(a, b, 2, 2)
    assert ints_equal
    for name, gap in gaps.items():
        assert gap <= 1e-12, (name, gap)


#: K6's (k, m) at the port's float64 solves (``width_gaps.py``: the RBF
#: fits' k with two right-hand sides, the polish's K with one) and K7's
#: (k, m) products, each at batch widths 1, 2 and 16
LANE_LU_SHAPES = [(k, FIT_M) for k in FIT_K] + [(k, 1) for k in POLISH_K] + [(12, 3)]
LANE_MATMUL_SHAPES = [(k, m) for k in sorted(set(FIT_K + POLISH_K)) for m in PRODUCT_M]
LANE_WIDTHS = (1, 2, 16)


def _bits_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        (a.contiguous().view(torch.uint8) == b.contiguous().view(torch.uint8)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k,m", LANE_LU_SHAPES)
def test_lane_lu_kernel_matches_twin(cuda, k, m, dtype):
    """K6's factor and solve against their twins on the card, to the bit
    (LU, permutation, info, x), the first w lanes of a batch of w against
    the twin's batch of 16; lane 3 is exactly singular (a zero column), so
    its info is set and ``lu_solve_nan`` gives nan on it alone."""
    from morbit_tpu_torch.ops import lane_linalg as ll

    rng = np.random.default_rng(1000 * k + m)
    A = torch.as_tensor(rng.standard_normal((16, k, k)), dtype=dtype, device=cuda)
    A[3, :, k // 2] = 0.0
    b = torch.as_tensor(rng.standard_normal((16, k, m)), dtype=dtype, device=cuda)
    LU_t, perm_t, info_t = ll.lane_lu_factor_plain(A)
    x_t = ll.lane_lu_solve_plain(LU_t, perm_t, b)
    assert int(info_t[3]) == k // 2 + 1 or k == 1
    for w in LANE_WIDTHS:
        LU, perm, info = ll.lane_lu_factor_cuda(A[:w].contiguous())
        x = ll.lane_lu_solve_cuda(LU, perm, b[:w].contiguous())
        torch.cuda.synchronize()
        for name, got, want in (("LU", LU, LU_t), ("perm", perm, perm_t),
                                ("info", info, info_t), ("x", x, x_t)):
            assert _bits_equal(got, want[:w]), (name, w)
    x = ll.lu_solve_nan(A, b)
    nan_lanes = torch.isnan(x).flatten(1).all(1).cpu().numpy()
    assert nan_lanes[3] and not nan_lanes[np.arange(16) != 3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", LANE_MATMUL_SHAPES)
def test_lane_matmul_kernel_matches_twin(cuda, k, m):
    """K7 against its twin on the card at float64, to the bit, the first w
    lanes of a batch of w against the twin's batch of 16; also a transposed
    operand and a broadcast batch axis, as ``lane_matmul``'s callers pass
    them."""
    from morbit_tpu_torch.ops import lane_linalg as ll

    rng = np.random.default_rng(10 * k + m)
    a = torch.as_tensor(rng.standard_normal((16, k, k)), device=cuda)
    b = torch.as_tensor(rng.standard_normal((16, k, m)), device=cuda)
    want = ll.lane_matmul_plain(a, b)
    for w in LANE_WIDTHS:
        assert _bits_equal(ll.lane_matmul_cuda(a[:w], b[:w]), want[:w]), w
    at = a.transpose(-1, -2)
    assert _bits_equal(ll.lane_matmul_cuda(at, b), ll.lane_matmul_plain(at, b))
    assert _bits_equal(ll.lane_matmul_cuda(a, b[0]), ll.lane_matmul_plain(a, b[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [36, 441, 2000])
def test_lane_sum_kernel_matches_twin(cuda, length):
    """``lane_sum`` on a float64 CUDA tensor (the RBF fit's centering sum,
    P^2 values a lane) is K7 against ones: equal to the bit to the twin's
    sum in index order, and the first w lanes of a batch of w to theirs in
    the batch of 16; the CPU's ``sum`` of more than 64 values may differ."""
    from morbit_tpu_torch.ops import batched_linalg, lane_linalg as ll

    x = torch.as_tensor(np.random.default_rng(length).standard_normal((16, length)),
                        device=cuda)
    ones = torch.ones((length, 1), dtype=torch.float64, device=cuda)
    want = ll.lane_matmul_plain(x[:, None, :], ones)[:, 0, 0]
    launched = ll.matmul_launches
    got = batched_linalg.lane_sum(x.reshape(16, -1, 1))
    assert ll.matmul_launches == launched + 1
    assert _bits_equal(got, want)
    for w in LANE_WIDTHS:
        assert _bits_equal(batched_linalg.lane_sum(x[:w]), want[:w]), w


@pytest.mark.cuda
def test_float64_routes_to_lane_kernels(cuda):
    """On the card, ``solve_small``'s float64 LU branch, the float64 polish
    and float64 ``lane_matmul`` launch K6 and K7 and never the library
    calls whose bits depend on the batch width; float32 calls keep their
    paths."""
    from morbit_tpu_torch.ops import batched_linalg, lane_linalg as ll
    from morbit_tpu_torch.ops.qp import _polish

    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.standard_normal((4, 12, 12)), device=cuda)
    b = torch.as_tensor(rng.standard_normal((4, 12, 2)), device=cuda)
    P, q, Aq, lo, hi = (torch.as_tensor(t, device=cuda) for t in random_qps(4, 21, 42, 0))
    z, y = torch.zeros_like(q), torch.zeros_like(lo)
    refuse = lambda *a, **k: pytest.fail("a float64 library solve ran on the card")
    with unittest.mock.patch.object(torch.linalg, "solve_ex", refuse), \
            unittest.mock.patch.object(torch.linalg, "lu_factor_ex", refuse), \
            unittest.mock.patch.object(torch.linalg, "lu_solve", refuse):
        ll.lu_factor_launches = ll.lu_solve_launches = ll.matmul_launches = 0
        x = batched_linalg.solve_small(A, b)
        assert (ll.lu_factor_launches, ll.lu_solve_launches) == (1, 1)
        assert _bits_equal(x, ll.lu_solve_nan(A, b))
        _polish(P, q, Aq, lo, hi, z, y)
        assert (ll.lu_factor_launches, ll.lu_solve_launches) == (3, 6)
        launched = ll.matmul_launches
        assert _bits_equal(batched_linalg.lane_matmul(A, b), ll.lane_matmul_plain(A, b))
        assert ll.matmul_launches == launched + 1
    launched = ll.matmul_launches
    batched_linalg.lane_matmul(A.float(), b.float())
    assert ll.matmul_launches == launched


@pytest.mark.cuda
def test_width_invariance_f64(cuda):
    """``width_gaps.py``'s problem at float64 (two parabolas, one
    multiquadric group, 16 Halton starts, max_iter=12, qp_iters=100): the
    plain runner over meshes of the card 2, 4, 8 and 16 times (shards of 8,
    4, 2 and 1 lanes) and ``StagedMultistart(schedule=(3, 6), widths=(16,
    8, 8))`` over a mesh of 4 each equal to the unsharded plain batch of 16
    to the bit, in every leaf after ``canonicalize_buffer_tails``."""
    from morbit_tpu_torch.tools.width_gaps import width_invariance

    out = width_invariance("cuda")
    assert all(not r["leaves_apart"] for r in out.values()), out
