"""The port's wide-n path against the JAX package, on the CPU.

On seeded numpy inputs:

* the ZDT and DTLZ problems (values and Jacobians, float64);
* the blocked Gauss-Jordan solve of the mid-size band (``solve_small`` for
  24 < k <= 512 at float32);
* the plain twins of the kernels K4 (``rbf_gram_matrix``) and K5
  (``admm_iterations``) against the Pallas kernels run in interpret mode;
* ``fit_rbf`` at float32 with P >= 128, which routes the Gram matrix to K4
  (its twin on the CPU);
* ``optimize`` on the ZDT1 n=10 golden and ``multistart_optimize`` on the
  ZDT1/ZDT2 n=5 RBF quality envelopes of ``tests/test_zdt_quality.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.ops.batched_linalg as jbl
import morbit_tpu.ops.pallas_kernels as jpk
import morbit_tpu.problems.synthetic as jsyn
import morbit_tpu_torch as mt
import morbit_tpu_torch.ops.batched_linalg as tbl
import morbit_tpu_torch.ops.rbf as trbf
import morbit_tpu_torch.problems.synthetic as tsyn
from morbit_tpu.utils.parity import compare_trajectories
from morbit_tpu_torch.models.configs import RbfConfig
from morbit_tpu_torch.ops import dense_kernels
from morbit_tpu_torch.utils.parity import export_trajectory
from chip_smoke import admm_iterations_case

F64 = torch.float64
PROBLEMS = ["zdt1", "zdt2", "zdt3", "zdt4", "zdt6", "dtlz1", "dtlz2", "dtlz6"]


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _functions(name, n, port):
    """The objectives of one problem as plain functions of x (n,), and its
    box."""
    syn = tsyn if port else jsyn
    if name.startswith("zdt"):
        lb, ub = syn.zdt_bounds(name, n)
        return syn.zdt_objectives(name, n), lb, ub
    mop = syn.make_dtlz(int(name[-1]), n, M=3)
    return [f.fn for f in mop.functions], mop.lb, mop.ub


# ------------------------------------------------------------------ problems

@pytest.mark.parametrize("n", [5, 20])
@pytest.mark.parametrize("name", PROBLEMS)
def test_problem_values_and_jacobians_match_jax(name, n):
    rng = np.random.default_rng(n)
    fns, lb, ub = _functions(name, n, True)
    jfns, jlb, jub = _functions(name, n, False)
    np.testing.assert_array_equal(lb, jlb)
    np.testing.assert_array_equal(ub, jub)
    X = lb + (ub - lb) * rng.uniform(0.05, 0.95, (4, n))
    for f, jf in zip(fns, jfns):
        vals = torch.func.vmap(f)(_t(X))
        jvals = jax.vmap(jf)(jnp.asarray(X))
        np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-12, atol=1e-12)
        J = torch.func.vmap(torch.func.jacrev(f))(_t(X))
        jJ = jax.vmap(jax.jacfwd(jf))(jnp.asarray(X))
        np.testing.assert_allclose(J.numpy(), np.asarray(jJ), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["zdt1", "zdt2", "zdt3", "zdt4", "zdt6"])
def test_zdt_front_matches_jax(name):
    np.testing.assert_array_equal(tsyn.zdt_front(name, 200), jsyn.zdt_front(name, 200))


# ----------------------------------------------------------- blocked solve

def _pivoting_systems(B, k, seed):
    """Well-conditioned systems whose pivots lie off the diagonal: a scaled
    random permutation plus noise."""
    rng = np.random.default_rng(seed)
    perm = np.stack([np.eye(k)[rng.permutation(k)] for _ in range(B)])
    A = 4.0 * np.sqrt(k) * perm + rng.normal(size=(B, k, k))
    return A, rng.normal(size=(B, k, 3))


@pytest.mark.parametrize("k", [40, 77])
def test_blocked_gj_solve_matches_jax_and_lu(k):
    A, b = _pivoting_systems(4, k, k)
    x32 = tbl.solve_small(_t(A, torch.float32), _t(b, torch.float32))
    jx32 = jax.vmap(jbl.blocked_gj_solve)(jnp.asarray(A, jnp.float32),
                                          jnp.asarray(b, jnp.float32))
    rel = np.abs(x32.numpy() - np.asarray(jx32)).max() / np.abs(np.asarray(jx32)).max()
    assert rel <= 1e-5
    # float64 (the dispatch would take LU there): against torch.linalg.solve
    x64 = tbl.blocked_gj_solve(_t(A), _t(b[..., 0]))
    np.testing.assert_allclose(x64.numpy(), torch.linalg.solve(_t(A), _t(b[..., 0])).numpy(),
                               rtol=0, atol=1e-10)


# ------------------------------------------------------------- kernel twins

@pytest.mark.parametrize("N", [24, 130])
@pytest.mark.parametrize("kernel", trbf.RBF_KERNELS)
def test_gram_twin_matches_pallas(kernel, N):
    rng = np.random.default_rng(N)
    sites = rng.uniform(0, 1, (3, N, 5))
    mask = rng.random((3, N)) > 0.3
    param = trbf.kernel_default_param(kernel) if kernel in trbf.EXPONENT_KERNELS else 1.3
    for dtype, jdt in ((F64, jnp.float64), (torch.float32, jnp.float32)):
        port = dense_kernels.rbf_gram_matrix(_t(sites, dtype), torch.as_tensor(mask),
                                             kernel, param).numpy()
        ref = np.asarray(jax.vmap(lambda s, m: jpk.rbf_gram_matrix(
            s, m, kernel, param, interpret=True))(jnp.asarray(sites, jdt), jnp.asarray(mask)))
        tol = 1e-12 if dtype == F64 else 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(port, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("n,m", [(3, 6), (21, 42)])
def test_admm_iterations_twin_matches_pallas(n, m):
    args = admm_iterations_case(4, n, m, seed=n)
    kw = dict(iters=100, sigma=1e-6, alpha=1.6)
    port = dense_kernels.admm_iterations(*(_t(a) for a in args), **kw)
    ref = jax.vmap(lambda *a: jpk.admm_iterations(*a, interpret=True, **kw))(
        *(jnp.asarray(a) for a in args))
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0, atol=1e-12)


def test_cpu_tensors_never_launch_k4_or_k5(monkeypatch):
    monkeypatch.setattr(dense_kernels, "gram_launches", 0)
    monkeypatch.setattr(dense_kernels, "admm_iterations_launches", 0)
    dense_kernels.rbf_gram_matrix(torch.zeros((1, 4, 2)), torch.ones((1, 4), dtype=bool),
                                  "cubic", 3.0)
    dense_kernels.admm_iterations(*(_t(a) for a in admm_iterations_case(2, 3, 6, 0)),
                                  iters=2, sigma=1e-6, alpha=1.6)
    assert dense_kernels.gram_launches == 0
    assert dense_kernels.admm_iterations_launches == 0


def test_f32_fit_at_p134_takes_the_gram_twin(monkeypatch):
    """``fit_rbf`` at float32 with P >= 128 (the ZDT n=14 training buffer)
    assembles its Gram matrix through K4's route; the KKT system (k = 149)
    takes the blocked solve, and the model reproduces its data."""
    calls = []
    plain = dense_kernels.rbf_gram_matrix_plain
    monkeypatch.setattr(dense_kernels, "rbf_gram_matrix_plain",
                        lambda *a: calls.append(1) or plain(*a))
    rng = np.random.default_rng(3)
    B, P, n = 2, 134, 14
    sites = rng.uniform(0, 1, (B, P, n))
    values = rng.normal(size=(B, P, 2))
    mask = np.arange(P)[None, :] < np.array([P, 100])[:, None]
    f32 = torch.float32
    fit = trbf.fit_rbf(_t(sites, f32), _t(values, f32), torch.as_tensor(mask),
                       kernel="cubic", poly_deg=1)
    assert calls == [1]
    for b in range(B):
        k = int(mask[b].sum())
        fb = trbf.RbfFit(*(f[b:b + 1] for f in fit))
        at = trbf.eval_rbf(fb, _t(sites[b:b + 1, :k], f32), "cubic", 1)[0].numpy()
        rel = np.abs(at - values[b, :k]).max() / np.abs(values[b, :k]).max()
        assert rel <= 1e-3


# ------------------------------------------------------------ whole solves

def test_zdt1_n10_trajectory_matches_golden():
    """``tests/test_golden.py:50-63``: ZDT1 n=10, cubic RBF objectives, f64."""
    mop = tsyn.make_zdt("zdt1", 10, model_cfg=RbfConfig(kernel="cubic"))
    res = mt.optimize(mop, np.linspace(0.15, 0.85, 10), max_iter=20, f_tol_rel=1e-6,
                      x_tol_rel=1e-6, device="cpu", dtype=F64)
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "zdt1_n10_rbf_cubic_f64.json")) as f:
        golden = json.load(f)
    rep = compare_trajectories(export_trajectory(res), golden, x_tol=1e-10)
    assert rep["parity"], rep


def _front_err(name, fx):
    f1 = np.clip(fx[:, 0], 0, None)
    front = {"zdt1": 1.0 - np.sqrt(f1), "zdt2": 1.0 - f1 ** 2}[name]
    return np.abs(fx[:, 1] - front)


@pytest.mark.parametrize("name", ["zdt1", "zdt2"])
def test_zdt_rbf_quality_envelope(name):
    """The RBF envelopes of ``tests/test_zdt_quality.py:35-56`` through the
    port's batched runner: n=5, 8 Halton starts, max_iter=25."""
    mop = tsyn.make_zdt(name, 5, model_cfg=RbfConfig(kernel="cubic"))
    ac = mt.AlgorithmConfig(max_iter=25, max_evals=1000 * 5, f_tol_rel=1e-3,
                            x_tol_rel=1e-3)
    res = mt.multistart_optimize(mop, tsyn.halton_starts(8, mop.lb, mop.ub), ac,
                                 dtype=F64, device="cpu")
    fx, evals = res.fx.numpy(), res.n_evals.numpy()
    fe = _front_err(name, fx)
    assert np.min(fe) < 0.01
    if name == "zdt1":
        assert np.median(fe) < 0.8
    assert np.median(evals) <= 30
    assert np.max(evals) <= 60


def _beyond_limits(kernel):
    """A call on CPU tensors past the kernel's limit by one (K5), or past
    the limit K1-K4 had before they took every shape."""
    from morbit_tpu_torch.ops import prepare_fused

    z = lambda *shape: torch.zeros(shape)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    if kernel == "selection":
        n = prepare_fused.SELECTION_BLOCK_MAX_N + 1
        return lambda: prepare_fused.selection_cuda(
            z(1, 4, n), i32(1), z(1, n), i32(1), z(1), z(1, n), z(1, n), i32(1),
            torch.zeros(1, dtype=bool), theta_e1=2.0, theta_e2_dmax=1.0,
            theta_pivot=0.25, delta_max=0.5, skip2_same_theta=True)
    if kernel == "round4":
        maxN = prepare_fused.ROUND4_WIDE_MAX_POINTS + 1
        return lambda: prepare_fused.round4_cuda(
            z(1, 4, 2), torch.zeros((1, 4), dtype=bool), z(1, maxN, 2), i32(1),
            kernel="cubic", param=3, poly_deg=1, max_points=maxN, chol_pivot=1e-7)
    if kernel == "admm_rows":
        from morbit_tpu_torch.ops import qp_lane

        nv, m = 2, qp_lane.WARP_MAX_M + 1
        return lambda: qp_lane.admm_stages_cuda(
            z(1, nv, nv), z(1, nv), z(1, m, nv), z(1, m), z(1, m), z(1, m),
            n_stages=1, n_steps=1, sigma=1e-6, alpha=1.6, rho_lo=1e-6, rho_hi=1e6)
    if kernel == "gram":
        # one lane's sites past the shared memory of a block
        P = 16384
        return lambda: dense_kernels.rbf_gram_cuda(
            z(1, P, 1), torch.ones((1, P), dtype=bool), "cubic", 3.0)
    n = dense_kernels.ADMM_ITERATIONS_MAX_N + 1
    return lambda: dense_kernels.admm_iterations_cuda(
        z(1, n, n), z(1, 2, n), z(1, 2), z(1, n), z(1, 2), z(1, 2), z(1, n), z(1, 2),
        z(1, 2), iters=1, sigma=1e-6, alpha=1.6)


@pytest.mark.parametrize("kernel", ["selection", "round4", "gram", "admm_iterations",
                                    "admm_rows"])
def test_kernels_refuse_beyond_their_limits(kernel):
    """K5 (no caller) refuses a shape past its limits; K1-K4 take every
    shape, so past their former limits the wrappers plan a launch and
    refuse only the CPU tensors they were given (a bad argument)."""
    if kernel == "admm_iterations":
        with pytest.raises(NotImplementedError, match="takes"):
            _beyond_limits(kernel)()
    else:
        with pytest.raises(ValueError, match="cuda"):
            _beyond_limits(kernel)()


@pytest.mark.parametrize("itemsize", [4, 8])
def test_kernel_blocks_fit_shared_memory(itemsize):
    """Every shape the K1, K2 and K5 wrappers take fits the H100's 227 KB of
    shared memory per block, at float32 and float64: K1 at each nv <= 32 and
    m <= 64, K2 at each n <= 32 (the register instances take none), K5 at
    each n <= 64 and m <= 128 with the instances a block its wrapper picks
    (1 to 4, every one of them whole, and a fifth would not have fitted
    where there are fewer than 4)."""
    from morbit_tpu_torch.ops import cuda_build, dense_kernels, prepare_fused, qp_lane

    admm = [qp_lane.admm_plan(nv, m, itemsize).smem_bytes
            for nv in range(1, qp_lane.WARP_MAX_NV + 1)
            for m in range(1, qp_lane.WARP_MAX_M + 1)]
    sel = [prepare_fused.selection_plan(n, itemsize).smem_bytes
           for n in range(1, prepare_fused.SELECTION_BLOCK_MAX_N + 1)]
    assert max(admm) <= cuda_build.SMEM_LIMIT and max(sel) <= cuda_build.SMEM_LIMIT
    assert qp_lane.admm_plan(3, 6, itemsize).smem_bytes == 0
    assert prepare_fused.selection_plan(2, itemsize).smem_bytes == 0
    assert prepare_fused.selection_stage_rows(20, itemsize) > 0
    for n in range(1, dense_kernels.ADMM_ITERATIONS_MAX_N + 1):
        for m in range(1, dense_kernels.ADMM_ITERATIONS_MAX_M + 1):
            lanes = dense_kernels.admm_iterations_lanes(n, m, itemsize)
            smem = dense_kernels.admm_iterations_smem_bytes(n, m, itemsize)
            assert 1 <= lanes <= dense_kernels.ADMM_ITERATIONS_MAX_LANES
            assert smem <= cuda_build.SMEM_LIMIT and smem % (lanes * 16) == 0
            if lanes < dense_kernels.ADMM_ITERATIONS_MAX_LANES:
                assert smem // lanes * (lanes + 1) > cuda_build.SMEM_LIMIT
    # the largest instance: two a block at float64, four at float32
    assert dense_kernels.admm_iterations_lanes(64, 128, itemsize) == (4 if itemsize == 4 else 2)


def test_admm_iterations_phase_probe_finds_its_marks():
    """``tools/admm_iterations_phases.py`` instruments K5 at its phase
    comments: each mark once, and the end once, before the outputs."""
    from morbit_tpu_torch.ops import dense_kernels
    from morbit_tpu_torch.tools.admm_iterations_phases import PHASES, instrument

    text = instrument(dense_kernels.ADMM_ITERATIONS_SOURCE.read_text())
    for k in range(1, len(PHASES)):
        assert text.count(f"MORBIT_PROBE({k});") == 1
    assert text.count("MORBIT_PROBE_END;") == 1
    assert text.index("MORBIT_PROBE_END;\n  // ---- outputs") > text.index("MORBIT_PROBE(4);")


@pytest.mark.parametrize("kernel", ["admm", "selection", "admm_iterations"])
def test_kernels_refuse_blocks_past_shared_memory(monkeypatch, kernel):
    """A shape whose block would not fit the shared memory of the card
    (here with the limit set below the wide path's block): K5 raises before
    any launch; K1 and K2 plan another instance whose block fits, so their
    wrappers refuse only the CPU tensors they were given."""
    from morbit_tpu_torch.ops import cuda_build, prepare_fused, qp_lane

    monkeypatch.setattr(cuda_build, "SMEM_LIMIT", 1024)
    z = lambda *shape: torch.zeros(shape)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    if kernel == "admm_iterations":
        from morbit_tpu_torch.ops import dense_kernels

        n, m = 21, 42
        call = lambda: dense_kernels.admm_iterations_cuda(
            z(1, n, n), z(1, m, n), z(1, m), z(1, n), z(1, m), z(1, m), z(1, n), z(1, m),
            z(1, m), iters=1, sigma=1e-6, alpha=1.6)
    elif kernel == "admm":
        nv, m = 21, 42
        call = lambda: qp_lane.admm_stages_cuda(
            z(1, nv, nv), z(1, nv), z(1, m, nv), z(1, m), z(1, m), z(1, m),
            n_stages=1, n_steps=1, sigma=1e-6, alpha=1.6, rho_lo=1e-6, rho_hi=1e6)
    else:
        n = 20
        call = lambda: prepare_fused.selection_cuda(
            z(1, 4, n), i32(1), z(1, n), i32(1), z(1), z(1, n), z(1, n), i32(1),
            torch.zeros(1, dtype=bool), theta_e1=2.0, theta_e2_dmax=1.0,
            theta_pivot=0.25, delta_max=0.5, skip2_same_theta=True)
    if kernel == "admm_iterations":
        with pytest.raises(NotImplementedError, match="shared memory"):
            call()
        return
    plan = (qp_lane.admm_plan(21, 42, 4) if kernel == "admm"
            else prepare_fused.selection_plan(20, 4))
    assert plan.smem_bytes <= 1024 and plan.work_elems > 0
    with pytest.raises(ValueError, match="cuda"):
        call()
