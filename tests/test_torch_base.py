"""The PyTorch port's base modules against the JAX package.

Enums and config defaults must be equal field by field, Halton starts
bit-equal, and geometry / scaling / tiny linear algebra equal within 1e-12
at float64 on the same seeded numpy inputs. Runs on the CPU.
"""

import dataclasses
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.core.config as jcfg
import morbit_tpu.core.enums as jenums
import morbit_tpu.core.scaling as jscal
import morbit_tpu.ops.batched_linalg as jla
import morbit_tpu.ops.geometry as jgeo
import morbit_tpu.problems.synthetic as jsyn
import morbit_tpu_torch as mt
import morbit_tpu_torch.core.config as tcfg
import morbit_tpu_torch.core.enums as tenums
import morbit_tpu_torch.core.scaling as tscal
import morbit_tpu_torch.ops.batched_linalg as tla
import morbit_tpu_torch.ops.geometry as tgeo
import morbit_tpu_torch.problems.synthetic as tsyn
from morbit_tpu.models.configs import LagrangeConfig as JaxLagrangeConfig
from morbit_tpu.models.configs import RbfConfig as JaxRbfConfig
from morbit_tpu.models.configs import TaylorConfig as JaxTaylorConfig
from morbit_tpu_torch.models.configs import LagrangeConfig, RbfConfig, TaylorConfig
from morbit_tpu_torch.parallel.multistart import build_solver
from morbit_tpu_torch.utils.carry import config_from_dict, state_to_numpy

TOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("name", ["ITER_TYPE", "STOP_CODE", "RADIUS_UPDATE"])
def test_enums_equal(name):
    ref = {e.name: int(e) for e in getattr(jenums, name)}
    port = {e.name: int(e) for e in getattr(tenums, name)}
    assert port == ref


def test_config_defaults_equal_field_by_field():
    ref = dataclasses.asdict(jcfg.AlgorithmConfig())
    port = dataclasses.asdict(tcfg.AlgorithmConfig())
    assert list(port) == list(ref)
    assert port == ref


@pytest.mark.parametrize("kw", [dict(), dict(max_iter=7, max_evals=40),
                                dict(db_capacity=33, trajectory_capacity=5,
                                     filter_capacity=9),
                                dict(use_db=False, max_critical_loops=2)])
def test_config_resolvers_and_carry(kw):
    jc = jcfg.AlgorithmConfig(**kw)
    pc = config_from_dict(dataclasses.asdict(jc))
    assert pc == tcfg.AlgorithmConfig(**kw)
    for n, mp, spi in [(2, 3, 0), (3, 10, 0), (10, 66, 30)]:
        assert pc.resolved_db_capacity(n, mp, spi) == jc.resolved_db_capacity(n, mp, spi)
    assert pc.resolved_filter_capacity() == jc.resolved_filter_capacity()
    assert pc.resolved_trajectory_capacity() == jc.resolved_trajectory_capacity()


@pytest.mark.parametrize("count,dim,start", [(1024, 2, 1), (37, 3, 5)])
def test_halton_starts_bit_equal(count, dim, start):
    lb, ub = -4.0 * np.ones(dim), 4.0 * np.ones(dim)
    np.testing.assert_array_equal(tsyn.halton_starts(count, lb, ub, start),
                                  jsyn.halton_starts(count, lb, ub, start))
    np.testing.assert_array_equal(tsyn.halton(count, dim, start),
                                  jsyn.halton(count, dim, start))


def _geo_inputs(seed, B=16, n=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, n))
    d = rng.normal(size=(B, n))
    d[0] = 0.0                          # zero direction
    d[1, 0] = 0.0                       # a coordinate that never moves
    lb = x - rng.uniform(0, 1, (B, n))
    ub = x + rng.uniform(0, 1, (B, n))
    lb[2, 1] = x[2, 1]                  # start on a bound
    A = rng.normal(size=(B, 2, n))
    b = np.einsum("bqn,bn->bq", A, x) + rng.uniform(0, 1, (B, 2))
    delta = rng.uniform(0.05, 0.5, B)
    return x, d, lb, ub, A, b, delta


@pytest.mark.parametrize("seed", [0, 1])
def test_geometry_matches_jax(seed):
    x, d, lb, ub, A, b, delta = _geo_inputs(seed)
    _close(tgeo.project_into_box(_t(3 * x), _t(lb), _t(ub)),
           jgeo.project_into_box(jnp.asarray(3 * x), lb, ub))
    lo_p, hi_p = tgeo.local_bounds(_t(x), _t(delta), _t(lb), _t(ub))
    lo_j, hi_j = jax.vmap(jgeo.local_bounds)(x, delta, lb, ub)
    _close(lo_p, lo_j)
    _close(hi_p, hi_j)
    for sense in (True, False):
        _close(tgeo._crossing_sigmas(_t(x), _t(lb), _t(d), sense),
               jgeo._crossing_sigmas(jnp.asarray(x), lb, jnp.asarray(d), sense))
    for mode in ("pos", "neg", "absmax", "both"):
        port = tgeo.intersect_bounds(_t(x), _t(d), _t(lb), _t(ub), _t(A),
                                     _t(b), ret_mode=mode)
        ref = jax.vmap(lambda *a: jgeo.intersect_bounds(
            *a, ret_mode=mode))(x, d, lb, ub, A, b)
        box = tgeo.intersect_box(_t(x), _t(d), _t(lb), _t(ub), mode)
        box_ref = jax.vmap(lambda *a: jgeo.intersect_box(
            *a, ret_mode=mode))(x, d, lb, ub)
        if mode != "both":
            port, ref, box, box_ref = [port], [ref], [box], [box_ref]
        for p, r in zip(list(port) + list(box), list(ref) + list(box_ref)):
            _close(p, r)


@pytest.mark.parametrize("mode,finite", [("default", True), ("none", True),
                                         ("default", False)])
def test_scaling_matches_jax(mode, finite):
    rng = np.random.default_rng(3)
    lb = rng.uniform(-5, 0, 4)
    ub = lb + rng.uniform(0.5, 9, 4)
    if not finite:
        lb[1] = -np.inf
    ps = tscal.get_var_scaler(_t(lb), _t(ub), mode)
    js = jscal.get_var_scaler(lb, ub, mode)
    for f in tscal.VarScaler._fields:
        _close(getattr(ps, f), getattr(js, f))
    X = rng.uniform(-3, 3, (5, 4))
    _close(tscal.transform(ps, _t(X)), jax.vmap(lambda v: jscal.transform(js, v))(X))
    _close(tscal.untransform(ps, _t(X)),
           jax.vmap(lambda v: jscal.untransform(js, v))(X))


def test_scaling_auto_is_not_ported():
    """Once unported, ``var_scaler='auto'`` now matches the JAX package: on
    a finite box (and in the runners, which pass no start) it is the
    unit-cube scaler, and with an unbounded box ``Solver`` estimates it from
    the groups' Jacobians at the start perturbed by ``default_rng(1234)``
    (JAX ``algorithm.py:295-304``), within 1e-12."""
    import morbit_tpu.core.algorithm as jalg
    from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
    from morbit_tpu.core.mop import compile_mop as jax_compile_mop
    from morbit_tpu_torch.core.algorithm import Solver
    from morbit_tpu_torch.core.mop import compile_mop

    lb, ub = [-1.0, 0.0], [1.0, 3.0]
    ps = tscal.get_var_scaler(_t(lb), _t(ub), "auto")
    js = jscal.get_var_scaler(np.asarray(lb), np.asarray(ub), "auto")
    for f in tscal.VarScaler._fields:
        _close(getattr(ps, f), getattr(js, f))
    x0 = [0.5, -2.0]
    port = Solver(compile_mop(tsyn.make_two_parabolas()), mt.AlgorithmConfig(var_scaler="auto"),
                  torch.float64, "cpu", x0_hint=x0)
    ref = jalg.Solver(jax_compile_mop(jsyn.make_two_parabolas()),
                      JaxConfig(var_scaler="auto"), jnp.float64, x0_hint=np.asarray(x0))
    for f in tscal.VarScaler._fields:
        _close(getattr(port.scal, f), getattr(ref.scal, f))
    assert not np.allclose(port.scal.scale.numpy(), 1.0)
    no_hint = Solver(compile_mop(tsyn.make_two_parabolas()),
                     mt.AlgorithmConfig(var_scaler="auto"), torch.float64, "cpu")
    np.testing.assert_array_equal(no_hint.scal.scale.numpy(), 1.0)


@pytest.mark.parametrize("k", [3, 5, 9])
def test_batched_linalg_matches_jax(k):
    rng = np.random.default_rng(k)
    B = 8
    G = rng.normal(size=(B, k, k))
    S = G @ G.transpose(0, 2, 1) + 0.5 * np.eye(k)     # SPD
    N = rng.normal(size=(B, k, k))                      # general (pivoting)
    rhs = rng.normal(size=(B, k))
    _close(tla.gj_solve(_t(N), _t(rhs)), jax.vmap(jla.gj_solve)(N, rhs), 1e-10)
    _close(tla.gj_inverse(_t(N)), jax.vmap(jla.gj_inverse)(N), 1e-10)
    L_p = tla.chol_factor(_t(S))
    _close(L_p, jax.vmap(jla.chol_factor)(S))
    _close(tla.chol_solve(L_p, _t(rhs)),
           jax.vmap(jla.chol_solve)(jax.vmap(jla.chol_factor)(S), rhs))


@pytest.mark.parametrize("shape", [(1, 8, 2), (9, 9, 1)])
def test_lane_matmul_is_batch_width_invariant(shape):
    """A float32 lane's product is the float64 product rounded once, the
    same bits at widths 1, 32 and 1024: a batched matrix product's order of
    summation depends on the algorithm picked for the batch size, which
    moved a lane of a compacted staged run on the card (ROADMAP 3.10)."""
    rng = np.random.default_rng(4)
    r, k, c = shape
    a = torch.as_tensor(rng.normal(size=(1024, r, k)), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(1024, k, c)), dtype=torch.float32)
    ref = (a.double() @ b.double()).float()
    for w in (1, 32, 1024):
        assert torch.equal(tla.lane_matmul(a[:w], b[:w]), ref[:w])
    v = b[..., 0]
    assert torch.equal(tla.lane_matvec(a[:, :, :k], v), ref[..., 0] if c == 1 else
                       (a.double() @ v.double()[..., None])[..., 0].float())
    a64 = a.double()
    assert torch.equal(tla.lane_matmul(a64, b.double()), a64 @ b.double())


def test_chol_factor_breakdown_gives_nan():
    M = torch.tensor([[[1.0, 2.0], [2.0, 1.0]]], dtype=torch.float64)
    assert not torch.isfinite(tla.chol_factor(M)).all()


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax nor the JAX
    package (whose name is a prefix of the port's)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import morbit_tpu_torch\n"
        "for m in pkgutil.walk_packages(morbit_tpu_torch.__path__, 'morbit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(k for k in new if k in ('jax', 'jaxlib', 'morbit_tpu')\n"
        "             or k.startswith(('jax.', 'jaxlib.', 'morbit_tpu.')))\n"
        "assert any(k.startswith('morbit_tpu_torch.') for k in new)\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is usable")
    mop = tsyn.make_two_parabolas(lb=[-4.0, -4.0], ub=[4.0, 4.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.optimize(mop, [0.5, 0.5], max_iter=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.multistart_optimize(mop, np.zeros((2, 2)))


def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_on():
    """Both TF32 flags True for the test (the caller's own setting), the
    values from before restored afterwards."""
    saved = _tf32_flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _recording_parabolas(seen, raise_after=None):
    """Two parabolas whose first objective records the TF32 flags at each
    call (and raises at call ``raise_after``)."""
    def f1(x):
        seen.append(_tf32_flags())
        if raise_after is not None and len(seen) > raise_after:
            raise ValueError("objective failed")
        return torch.sum((x - 1.0) ** 2)

    mop = mt.MOP([-4.0, -4.0], [4.0, 4.0])
    mop.add_exact_objective(f1, jac=lambda x: 2.0 * (x - 1.0))
    mop.add_exact_objective(lambda x: torch.sum((x + 1.0) ** 2),
                            jac=lambda x: 2.0 * (x + 1.0))
    return mop


def test_solver_pins_full_precision_matmuls(tf32_on):
    """Inside the solver both TF32 flags are False (every objective call
    sees them so); after ``optimize`` returns they hold the caller's True
    again, as the JAX package scopes ``default_matmul_precision``."""
    seen = []
    mt.optimize(_recording_parabolas(seen), [0.5, -2.0], device="cpu", max_iter=2)
    assert seen and set(seen) == {(False, False)}
    assert _tf32_flags() == (True, True)


@pytest.mark.parametrize("entry", ["multistart_optimize", "iterate"])
def test_solver_restores_tf32_flags_after_each_call(tf32_on, entry):
    seen = []
    mop = _recording_parabolas(seen)
    starts = np.array([[0.5, -2.0], [1.5, 3.0]])
    if entry == "multistart_optimize":
        mt.multistart_optimize(mop, starts, mt.AlgorithmConfig(max_iter=2),
                               dtype=torch.float64, device="cpu")
    else:
        solver = build_solver(mop, mt.AlgorithmConfig(max_iter=2),
                              dtype=torch.float64, device="cpu")
        state = solver.initialize(starts)
        assert _tf32_flags() == (True, True)
        solver.iterate(state)
    assert seen and set(seen) == {(False, False)}
    assert _tf32_flags() == (True, True)


def test_solver_restores_tf32_flags_when_an_objective_raises(tf32_on):
    seen = []
    with pytest.raises(ValueError, match="objective failed"):
        mt.optimize(_recording_parabolas(seen, raise_after=2), [0.5, -2.0],
                    device="cpu", max_iter=5)
    assert len(seen) == 3 and set(seen) == {(False, False)}
    assert _tf32_flags() == (True, True)


@pytest.mark.parametrize("cfg", [RbfConfig(use_max_points=True),
                                 JaxTaylorConfig(), JaxLagrangeConfig()])
def test_unported_models_raise(cfg):
    """(The name is kept from when these raised.) Every model option is
    ported: ``RbfConfig(use_max_points=True)``
    builds and solves one iteration (``tests/test_torch_max_points.py``
    holds it against the JAX package); the port's Taylor and Lagrange
    configs with the JAX configs' fields and defaults build and solve one
    iteration; a composite objective over an inner function compiles and
    solves one iteration."""
    mop = mt.MOP([-1.0], [1.0])
    if isinstance(cfg, RbfConfig):
        mop.add_objective(lambda x: (x ** 2).sum(), model_cfg=cfg)
        res = mt.optimize(mop, [0.5], max_iter=1, device="cpu")
        assert int(res.n_iterations) == 1 and torch.isfinite(res.x).all()
        assert res.state.key is not None and res.state.key.shape == (2,)
    else:
        port_cfg = {JaxTaylorConfig: TaylorConfig, JaxLagrangeConfig: LagrangeConfig}[
            type(cfg)](**dataclasses.asdict(cfg))
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
        assert list(dataclasses.asdict(port_cfg)) == list(dataclasses.asdict(cfg))
        mop.add_objective(lambda x: (x ** 2).sum(), model_cfg=port_cfg)
        res = mt.optimize(mop, [0.5], max_iter=1, device="cpu")
        assert int(res.n_iterations) == 1 and torch.isfinite(res.x).all()
    # constraints and composites are ported
    mop.add_ineq_constraint([[1.0]], [0.5])
    g = mop.add_function(lambda x: (x - 0.25) ** 2, model_cfg=RbfConfig(kernel="cubic"))
    mop.add_composite_objective(lambda x, v: v.sum() + x[0], g)
    res = mt.optimize(mop, [0.5], max_iter=1, device="cpu")
    assert int(res.n_iterations) == 1 and torch.isfinite(res.fx).all()
    assert res.fx.shape[-1] == mop.num_objectives
    # the RBF config carries the JAX package's fields and defaults
    ref = dataclasses.asdict(JaxRbfConfig())
    port = dataclasses.asdict(RbfConfig())
    assert list(port) == list(ref)
    assert {k: v for k, v in port.items() if k != "shape_parameter"} == {
        k: v for k, v in ref.items() if k != "shape_parameter"}


@pytest.mark.parametrize("runner", ["multistart_optimize", "StagedMultistart",
                                    "staged_multistart"])
def test_mesh_argument_raises_naming_its_item(runner):
    """(The name is kept from when the argument raised.) The runners take
    the JAX package's ``mesh``: with a mesh of two CPU devices the batch
    runs as two shards, and the result equals the run without a mesh leaf
    by leaf (``tests/test_torch_mesh.py`` holds the JAX package's mesh
    tests)."""
    mop = tsyn.make_two_parabolas()
    x0 = tsyn.halton_starts(4, [-4.0, -4.0], [4.0, 4.0])
    ac = mt.AlgorithmConfig(max_iter=4, qp_iters=100)
    mesh = ["cpu", "cpu"]
    call = {"multistart_optimize": lambda m: mt.multistart_optimize(
                mop, x0, ac, torch.float64, device="cpu", mesh=m),
            "StagedMultistart": lambda m: mt.StagedMultistart(
                mop, ac, torch.float64, schedule=(2,), device="cpu", mesh=m)(x0),
            "staged_multistart": lambda m: mt.staged_multistart(
                mop, x0, ac, torch.float64, schedule=(2,), device="cpu", mesh=m)}[runner]
    res, ref = call(mesh), call(None)
    a, b = state_to_numpy(res.state), state_to_numpy(ref.state)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert res.trips == ref.trips


def test_verbosity_three_warns_once_and_prints_the_report(capsys):
    """(The name is kept from when level 3 warned.) ``optimize(verbosity=3)``
    prints the live per-iteration banner and no warning, then the report;
    the adders take ``host``/``can_batch``."""
    mop = mt.MOP([-2.0, -2.0], [2.0, 2.0])
    mop.add_objective(lambda x: np.sum((x - 1.0) ** 2), host=True,
                      model_cfg=RbfConfig(kernel="multiquadric"))
    mop.add_exact_objective(lambda X: np.sum((X + 1.0) ** 2, axis=-1), host=True,
                            can_batch=True)
    mop.add_nl_ineq_constraint(lambda x: np.sum(x ** 2) - 50.0, host=True,
                               model_cfg=RbfConfig(kernel="cubic"))
    mop.add_nl_eq_constraint(lambda x: torch.sum(x * 0.0), host=False)
    mop.add_function(lambda x: np.sum(x), host=True, can_batch=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = mt.optimize(mop, [0.5, -0.5], max_iter=2, verbosity=3, device="cpu")
    out = capsys.readouterr().out
    banners = [ln for ln in out.splitlines() if ln.startswith("| Iteration ")]
    assert len(banners) == int(res.n_iterations) >= 1
    assert banners[0].startswith("| Iteration 1: delta=")
    assert "| iter   0" in out and "FINISHED" in out


def test_qp_exit_eps_still_raises():
    """(The name is kept from when it raised.) ``AlgorithmConfig.qp_exit_eps``
    (the QP's early exit) is ported: a solver with it builds and solves one
    iteration
    (``tests/test_torch_exit_eps.py`` holds it against the JAX package)."""
    solver = build_solver(tsyn.make_two_parabolas(), mt.AlgorithmConfig(
        qp_exit_eps=1e-6, max_iter=1), torch.float64, "cpu")
    res = solver.solve(torch.tensor([[0.5, -2.0]], dtype=torch.float64))
    assert int(res.n_iterations[0]) == 1 and torch.isfinite(res.x).all()


@pytest.mark.parametrize("window", [None, 2])
def test_database_matches_jax(window):
    """Inserts (with one dropped by overflow), missing-value evaluation,
    box queries and row gathers of the batched database against the JAX
    package's single-instance database, lane by lane."""
    import morbit_tpu.core.database as jdb
    import morbit_tpu_torch.core.database as tdb

    rng = np.random.default_rng(7)
    B, cap, n, m = 3, 6, 2, 2
    fn_np = lambda X: np.stack([np.sum(X ** 2, -1), np.sum(X, -1)], -1)
    sites = rng.uniform(-1, 1, (B, cap + 1, n))
    pdb = tdb.init_database(B, cap, n, m, torch.float64, "cpu")
    jdbs = [jdb.init_database(cap, n, m, jnp.float64) for _ in range(B)]
    for k in range(cap + 1):                 # the last insert overflows
        y = fn_np(sites[:, k])
        evaluated = k % 2 == 0
        vals = y if evaluated else np.zeros_like(y)
        pdb, pidx = tdb.add_evaluated(pdb, _t(sites[:, k]), _t(vals))
        if not evaluated:                    # mark unevaluated, as add_site does
            data = pdb.data.clone()
            hit = torch.arange(cap)[None, :] == pidx[:, None]
            data[..., n + m] = torch.where(hit, 0.0, data[..., n + m])
            pdb = tdb.Database(data, pdb.count, pdb.overflow, n, m)
        for b in range(B):
            if evaluated:
                jdbs[b], jidx = jdb.add_evaluated(jdbs[b], jnp.asarray(sites[b, k]),
                                                  jnp.asarray(vals[b]))
            else:
                jdbs[b], jidx = jdb.add_site(jdbs[b], jnp.asarray(sites[b, k]))
            assert int(pidx[b]) == int(jidx)
    assert pdb.overflow.all()
    pdb, pn = tdb.eval_missing(
        pdb, lambda X: torch.as_tensor(fn_np(X.numpy())), window=window)
    lb, ub = rng.uniform(-1, 0, (B, n)), rng.uniform(0, 1, (B, n))
    pmask = tdb.results_in_box(pdb, _t(lb), _t(ub),
                               exclude_index=torch.tensor([0, 1, -1]))
    idx = np.array([[0, 3, -1], [5, -1, 2], [1, 1, 4]])
    pX, pY = tdb.get_rows(pdb, torch.as_tensor(idx))
    for b, jd in enumerate(jdbs):
        jd, jn = jdb.eval_missing(jd, lambda x: jnp.stack(
            [jnp.sum(x ** 2), jnp.sum(x)]), window=window)
        assert int(pn[b]) == int(jn)
        _close(pdb.data[b], jd.data)
        assert int(pdb.count[b]) == int(jd.count)
        jmask = jdb.results_in_box(jd, jnp.asarray(lb[b]), jnp.asarray(ub[b]),
                                   exclude_index=[0, 1, -1][b])
        np.testing.assert_array_equal(pmask[b].numpy(), np.asarray(jmask))
        jX, jY = jdb.get_rows(jd, jnp.asarray(idx[b]))
        _close(pX[b], jX)
        _close(pY[b], jY)


def test_compile_mop_groups_match_jax():
    """Grouping, output offsets, budgets and duplicate registrations (one
    callable added twice is one function, ``RefVecFun``) as in JAX."""
    from morbit_tpu.core.mop import MOP as JaxMOP
    from morbit_tpu.core.mop import compile_mop as jax_compile
    from morbit_tpu_torch.core.mop import compile_mop

    t1, t2 = (lambda x: torch.sum(x ** 2)), (lambda x: torch.stack([x[0], x[1]]))
    j1, j2 = (lambda x: jnp.sum(x ** 2)), (lambda x: jnp.stack([x[0], x[1]]))
    port, ref = mt.MOP([-1.0, -1.0], [1.0, 1.0]), JaxMOP([-1.0, -1.0], [1.0, 1.0])
    for mop, f1, f2 in ((port, t1, t2), (ref, j1, j2)):
        mop.add_exact_objective(f1, max_evals=30)
        mop.add_exact_objective(f2, n_out=2)
        mop.add_exact_objective(f1)
    cp, cj = compile_mop(port), jax_compile(ref)
    assert cp.m_obj == cj.m_obj == 4
    assert len(cp.groups) == len(cj.groups) == 2
    for gp, gj in zip(cp.groups, cj.groups):
        assert (gp.m, gp.max_evals, gp.has_objective) == (gj.m, gj.max_evals,
                                                          gj.has_objective)
        assert [(mb.fn_index, mb.group_offset, mb.global_offset, mb.n_out)
                for mb in gp.members] == [
            (mb.fn_index, mb.group_offset, mb.global_offset, mb.n_out)
            for mb in gj.members]
    x = np.array([0.3, -0.7])
    vals = [g.eval_unscaled(_t(x)[None]) for g in cp.groups]
    _close(cp.scatter_role_vectors(vals)[0][0], cj.scatter_role_vectors(
        [g.eval_unscaled(jnp.asarray(x)) for g in cj.groups], jnp.float64)[0])
