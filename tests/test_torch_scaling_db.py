"""Scaling modes and database options of the PyTorch port against the JAX
package.

At float64 on the CPU: oracle configs rbf-scaler-model (1e-8) and
nl-scaler-model (1e-12); the ``populated_db`` recycling pair of the full
oracle (1e-9); ``estimate_auto_scaler``, the batched ``'model'`` estimate,
``compact_to_row`` and ``rescale`` against JAX's; ``use_db=False`` on the
three configs of ``tests/test_use_db.py`` trip by trip from JAX's states
(integers exact, floats within 1e-10); ``untransform_final_database`` and
``var_scaler='auto'`` through ``optimize``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.core.algorithm as jalg
import morbit_tpu.core.database as jdb
import morbit_tpu.core.scaling as jscal
import morbit_tpu.utils.logging as jlog
import morbit_tpu_torch as mt
import morbit_tpu_torch.core.database as tdb
import morbit_tpu_torch.core.scaling as tscal
import morbit_tpu_torch.utils.logging as tlog
import tests.test_oracle_full_parity as jfull
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu.core.mop import MOP as JaxMOP
from morbit_tpu.core.mop import compile_mop as jax_compile_mop
from morbit_tpu.models.configs import RbfConfig as JaxRbf
from morbit_tpu.models.configs import TaylorConfig as JaxTaylor
from morbit_tpu_torch.core.algorithm import Solver
from morbit_tpu_torch.core.mop import compile_mop
from morbit_tpu_torch.models.configs import ExactConfig, RbfConfig, TaylorConfig
from morbit_tpu_torch.utils.carry import config_from_dict, state_from_numpy, state_to_numpy
from morbit_tpu_torch.utils.tree import tree_where
from tests.oracle_full import solve_oracle_full
from tests.test_torch_constraints import _CONS, _parabolas, jax_state_leaves

F64 = torch.float64
LB2, UB2 = [-4.0, -4.0], [4.0, 4.0]


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


# ------------------------------------------------------------------ oracles

@pytest.mark.parametrize("label", ["rbf-scaler-model", "nl-scaler-model"])
def test_scaler_model_matches_full_oracle(label):
    """The per-iteration ``'model'`` scaler update with the databases and
    linear rows re-transformed: oracle rbf-scaler-model (1e-8) and, through
    restoration, nl-scaler-model (1e-12)."""
    make, kw = jfull.CASES[label]
    kw = dict(kw)
    tol, require = kw.pop("tol"), kw.pop("_require", ())
    _, groups, lb, ub, x0 = make()
    if label == "rbf-scaler-model":
        mop = _parabolas(RbfConfig(kernel="multiquadric", max_model_points=3))
    else:
        mop = _parabolas()
        mop.add_nl_ineq_constraint(_CONS["ball"], model_cfg=ExactConfig())
    res = mt.optimize(mop, x0, device="cpu", dtype=F64, **kw)
    orc = solve_oracle_full(lb, ub, groups, x0, **kw)
    jfull._assert_parity(res, orc, tol, (), require)
    np.testing.assert_array_equal(res.state.scal.offset.numpy(), 0.0)


def test_populated_db_recycling_matches_oracle():
    """``test_oracle_populated_db_recycling``'s pair of runs: the second
    from another start recycles the first's databases (counters reset,
    models rebuilt from the richer data), each within 1e-9 of the oracle."""
    make, _ = jfull._rbf_case("multiquadric", max_iter=8)
    _, groups, lb, ub, x0 = make()
    mop = lambda: _parabolas(RbfConfig(kernel="multiquadric", max_model_points=3))
    res1 = mt.optimize(mop(), x0, device="cpu", dtype=F64, max_iter=8)
    orc1 = solve_oracle_full(lb, ub, groups, x0, max_iter=8)
    jfull._assert_parity(res1, orc1, 1e-9)
    x0b = np.array([2.0, -3.0])
    res2 = mt.optimize(mop(), x0b, device="cpu", dtype=F64, max_iter=8, populated_db=res1)
    orc2 = solve_oracle_full(lb, ub, groups, x0b, max_iter=8, populated_db=orc1.dbs)
    assert orc2.traj_x_index[0][0] == len(orc1.dbs[0])
    jfull._assert_parity(res2, orc2, 1e-9)


# ------------------------------------------------------- scaler and db units

@pytest.mark.parametrize("case", ["bounded_mix", "unbounded", "zero_column"])
def test_estimate_auto_scaler_matches_jax(case):
    rng = np.random.default_rng({"bounded_mix": 1, "unbounded": 2, "zero_column": 3}[case])
    J = rng.normal(size=(3, 4)) * 10.0 ** rng.integers(-3, 4, size=(1, 4))
    lb, ub = np.full(4, -np.inf), np.full(4, np.inf)
    if case != "unbounded":
        lb[:2], ub[:2] = [-1.0, 0.0], [2.0, 5e3]
    if case == "zero_column":
        J[:, 3] = 0.0
    port = tscal.estimate_auto_scaler(J, lb, ub)
    ref = jscal.estimate_auto_scaler(J, lb, ub)
    for f in tscal.VarScaler._fields:
        np.testing.assert_allclose(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-15, atol=0)


@pytest.mark.parametrize("bounded", [(True, True, False), (False, False, False)])
def test_model_scale_estimate_matches_jax(bounded):
    """The batched ``'model'`` estimate lane by lane against JAX's traced
    estimate, with a zero column and a zero target row on some lanes."""
    rng = np.random.default_rng(5)
    B, rows, n = 6, 4, 3
    J = rng.normal(size=(B, rows, n)) * 10.0 ** rng.integers(-2, 3, size=(B, 1, n))
    J[1, :, 2] = 0.0
    J[2, 0, :] = 0.0
    J[3, :, :2] = 0.0
    mask = np.array(bounded)
    lb = np.where(mask, [-1.0, 0.0, -2.0], -np.inf)
    ub = np.where(mask, [3.0, 1e3, 2.0], np.inf)
    port = tscal.estimate_linear_scaling_traced(_t(J), _t(lb), _t(ub), mask)
    ref = jax.vmap(lambda j: jscal.estimate_linear_scaling_traced(
        j, jnp.asarray(lb), jnp.asarray(ub), mask))(jnp.asarray(J))
    for f in tscal.VarScaler._fields:
        np.testing.assert_allclose(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-14, atol=0)


def test_compact_to_row_and_rescale_match_jax():
    """``compact_to_row`` (a negative index empties a lane) and ``rescale``
    (valid rows only) per lane against JAX's on the same databases."""
    rng = np.random.default_rng(11)
    B, cap, n, m = 5, 9, 3, 2
    data = rng.normal(size=(B, cap, n + m + 1))
    data[..., -1] = (rng.uniform(size=(B, cap)) > 0.3).astype(float)
    count = np.array([0, 3, 9, 5, 1], np.int32)
    idx = np.array([-1, 2, 8, 0, 0], np.int32)
    mk = lambda: tdb.Database(data=_t(data), count=torch.as_tensor(count),
                              overflow=torch.zeros(B, dtype=torch.bool), n=n, m=m)
    jmk = lambda b: jdb.Database(data=jnp.asarray(data[b]), count=jnp.asarray(count[b]),
                                 overflow=jnp.asarray(False), n=n, m=m)
    comp = tdb.compact_to_row(mk(), torch.as_tensor(idx))
    scal = [rng.uniform(0.1, 3.0, (B, n)) for _ in range(4)]
    res = tdb.rescale(mk(), *(_t(s) for s in scal))
    for b in range(B):
        jc = jdb.compact_to_row(jmk(b), jnp.asarray(idx[b]))
        np.testing.assert_array_equal(comp.data[b].numpy(), np.asarray(jc.data))
        assert int(comp.count[b]) == int(jc.count)
        jr = jdb.rescale(jmk(b), *(jnp.asarray(s[b]) for s in scal))
        np.testing.assert_allclose(res.data[b].numpy(), np.asarray(jr.data), rtol=1e-15,
                                   atol=0)


# ------------------------------------------------------------- use_db=False

def _use_db_mop(case, port):
    MOP, s = (mt.MOP, torch) if port else (JaxMOP, jnp)
    if case == "taylor":
        n = 5
        mop = MOP([-2.0] * n, [2.0] * n)
        cfg = (TaylorConfig if port else JaxTaylor)(degree=2)
        mop.add_objective(lambda x: s.sum((x - 1.0) ** 2).reshape(1), model_cfg=cfg)
        mop.add_objective(lambda x: s.sum((x + 1.0) ** 2).reshape(1), model_cfg=cfg)
        return mop
    mop = MOP(LB2, UB2)
    for c in (1.0, -1.0):
        f = lambda x, c=c: s.sum((x - c) ** 2)
        if case == "exact":
            mop.add_exact_objective(f)
        else:
            mop.add_objective(f, model_cfg=(RbfConfig if port else JaxRbf)(
                kernel="multiquadric"))
    return mop


def _assert_leaves_equal(port, ref, tol, rho_col):
    """Integer leaves exact; floats within ``tol`` times the leaf's largest
    magnitude (at least 1), but for the stamped rho (1e-4 relative) and the
    RBF fit coefficients (1e-7 of the largest): near-zero weights of a fit
    that its polynomial tail makes exact are rounding noise."""
    assert set(port) == set(ref)
    for name, a in port.items():
        b = ref[name]
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        big = max(1.0, float(np.max(np.abs(b[np.isfinite(b)]), initial=0.0)))
        if ".fit." in name:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-7 * big, err_msg=name)
            continue
        if name == "traj.data":
            np.testing.assert_allclose(a[..., rho_col], b[..., rho_col], rtol=1e-4,
                                       atol=tol, err_msg="rho")
            a, b = np.delete(a, rho_col, -1), np.delete(b, rho_col, -1)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * big, err_msg=name)


def _lockstep(jsolver, solver, init, compare, leaves=jax_state_leaves):
    """Every trip of JAX's batched solve from ``init``: the port's trip from
    JAX's state (carried with ``state_from_numpy``) against JAX's next
    state, ``compare(port_leaves, jax_leaves)``. Returns JAX's final state
    and the trips."""
    jiter = jax.jit(jax.vmap(lambda s: jax.lax.cond(
        s.stop_code == 1, jsolver.iterate, lambda t: t, s)))
    st, trips = init, 0
    while bool((np.asarray(st.stop_code) == 1).any()):
        state = state_from_numpy(leaves(st), device="cpu")
        port = tree_where(state.stop_code == 1, solver.iterate(state), state)
        st = jiter(st)
        compare(state_to_numpy(port), leaves(st))
        trips += 1
    return st, trips


def _with_taylor(leaves, st):
    for i, g in enumerate(st.groups):
        if hasattr(g.model, "site_idx"):
            for f in g.model._fields:
                leaves[f"groups.{i}.model.{f}"] = np.asarray(getattr(g.model, f))
    return leaves


USE_DB_CASES = {"exact": ([-3.0, 2.5], 15), "rbf": ([-3.0, 2.5], 15),
                "taylor": ([0.5, -0.5, 0.25, -0.25, 0.1], 6)}


@pytest.mark.parametrize("case", USE_DB_CASES)
def test_use_db_false_matches_jax(case):
    """The three configs of ``tests/test_use_db.py`` with ``use_db=False``
    (lanes of two starts), trip by trip: the port's trip from JAX's state
    equals JAX's next state, every leaf (integers exact, floats within
    1e-10). Exact and Taylor models also run freely to JAX's final state;
    an RBF run rebuilds its model from box exits every iteration, and
    those exits tie up to the last bit of the iterate (ROADMAP 3.8), so its
    free runs part. The database keeps its small fixed capacity, and exact
    models follow the same iterates as with the database on."""
    x0, max_iter = USE_DB_CASES[case]
    kw = dict(max_iter=max_iter, use_db=False)
    x0s = np.stack([x0, np.asarray(x0) * 0.5])
    jsolver = jalg.Solver(jax_compile_mop(_use_db_mop(case, False)), JaxConfig(**kw),
                          jnp.float64)
    leaves = lambda st: _with_taylor(jax_state_leaves(st), st)
    solver = Solver(compile_mop(_use_db_mop(case, True)),
                    config_from_dict(dataclasses.asdict(JaxConfig(**kw))), F64, "cpu")
    n = x0s.shape[1]
    compare = lambda a, b: _assert_leaves_equal(a, b, 1e-10, n + 2 + 1)
    init = jax.jit(jax.vmap(jsolver.initialize))(jnp.asarray(x0s))
    st, trips = _lockstep(jsolver, solver, init, compare, leaves)
    assert trips > 2
    final, _ = solver.solve_from_state(state_from_numpy(leaves(init), device="cpu"))
    if case != "rbf":
        compare(state_to_numpy(final), leaves(st))
    assert final.groups[0].db.data.shape[1] == solver.db_capacity < Solver(
        compile_mop(_use_db_mop(case, True)), mt.AlgorithmConfig(), F64, "cpu").db_capacity
    if case == "exact":
        on = mt.multistart_optimize(_use_db_mop(case, True), x0s,
                                    mt.AlgorithmConfig(max_iter=max_iter), F64, "cpu")
        off = mt.multistart_optimize(_use_db_mop(case, True), x0s,
                                     mt.AlgorithmConfig(**kw), F64, "cpu")
        np.testing.assert_allclose(off.state.traj.x.numpy(), on.state.traj.x.numpy(),
                                   rtol=0, atol=1e-12)


def test_scaler_model_lockstep_matches_jax():
    """The per-iteration ``'model'`` update on the main path's problem at
    B=4, trip by trip from JAX's states (carried with the per-lane scaler
    each trip changes): every leaf, the scaler and the rescaled databases
    included, within 1e-10 (integers exact)."""
    kw = dict(max_iter=10, var_scaler_update="model")
    x0s = np.array([[-3.0, 2.5], [2.0, -3.0], [0.5, 3.5], [-1.0, -1.5]])
    jsolver = jalg.Solver(jax_compile_mop(_use_db_mop("rbf", False)), JaxConfig(**kw),
                          jnp.float64)
    solver = Solver(compile_mop(_use_db_mop("rbf", True)),
                    config_from_dict(dataclasses.asdict(JaxConfig(**kw))), F64, "cpu")
    init = jax.jit(jax.vmap(jsolver.initialize))(jnp.asarray(x0s))
    st, trips = _lockstep(jsolver, solver, init,
                          lambda a, b: _assert_leaves_equal(a, b, 1e-10, 2 + 2 + 1))
    assert trips > 2
    np.testing.assert_array_equal(np.asarray(st.scal.offset), 0.0)


# -------------------------------------------- optimize: untransform, 'auto'

def _scaled_mop(port, lb, ub):
    """``examples/variable_scaling.py``'s badly scaled problem on the box
    (lb, ub)."""
    MOP, Rbf = (mt.MOP, RbfConfig) if port else (JaxMOP, JaxRbf)
    mop = MOP(lb, ub)
    cfg = Rbf(kernel="multiquadric")
    mop.add_objective(lambda x: (x[0] - 0.3) ** 2 + (x[1] / 1e4 - 0.3) ** 2, model_cfg=cfg)
    mop.add_objective(lambda x: (x[0] - 0.7) ** 2 + (x[1] / 1e4 - 0.7) ** 2, model_cfg=cfg)
    return mop


def _assert_runs_equal(port, ref, tol):
    assert int(port.stop_code) == int(ref.stop_code)
    assert int(port.n_iterations) == int(ref.n_iterations)
    assert [int(g.n_evals) for g in port.state.groups] == [
        int(g.n_evals) for g in ref.state.groups]
    tp, tr = tlog.trajectory_arrays(port), jlog.trajectory_arrays(ref)
    assert tp["it_stat"].tolist() == tr["it_stat"].tolist()
    np.testing.assert_array_equal(tp["x_indices"], tr["x_indices"])
    for name in ("x", "fx", "delta"):
        np.testing.assert_allclose(tp[name], tr[name], rtol=tol, atol=0, err_msg=name)


def test_auto_scaler_unbounded_matches_jax():
    """``var_scaler='auto'`` on an unbounded variant of
    ``examples/variable_scaling.py``: ``optimize`` estimates the scaler from
    the groups' Jacobians at the start perturbed by ``default_rng(1234)``,
    as JAX's does (the factors within 1e-14 relative), and runs as JAX's
    (integers exact, x, fx and the radius within 1e-9 relative). The
    runners take no start hint, so there 'auto' is 'default'."""
    lb, ub = [-np.inf, -np.inf], [np.inf, np.inf]
    x0 = np.array([0.9, 9.0e3])
    kw = dict(max_iter=12, var_scaler="auto")
    port = mt.optimize(_scaled_mop(True, lb, ub), x0, device="cpu", dtype=F64, **kw)
    ref = jalg.optimize(_scaled_mop(False, lb, ub), jnp.asarray(x0), dtype=jnp.float64,
                        **kw)
    np.testing.assert_allclose(port.state.scal.scale.numpy(), np.asarray(ref.state.scal.scale),
                               rtol=1e-14, atol=0)
    assert not np.allclose(port.state.scal.scale.numpy(), 1.0)
    _assert_runs_equal(port, ref, 1e-9)
    runner = mt.multistart_optimize(_scaled_mop(True, lb, ub), x0[None],
                                    mt.AlgorithmConfig(max_iter=1, var_scaler="auto"),
                                    F64, "cpu")
    np.testing.assert_array_equal(runner.state.scal.scale.numpy(), 1.0)


def test_untransform_final_database_matches_jax():
    """``untransform_final_database``: the returned databases hold unscaled
    sites (JAX's, within 1e-12) and the scaler is the identity; recycling
    that result through ``populated_db`` runs as JAX's does."""
    x0 = np.array([0.9, 9.0e3])
    lb, ub = [0.0, 0.0], [1.0, 1.0e4]
    kw = dict(max_iter=8, untransform_final_database=True)
    port = mt.optimize(_scaled_mop(True, lb, ub), x0, device="cpu", dtype=F64, **kw)
    ref = jalg.optimize(_scaled_mop(False, lb, ub), jnp.asarray(x0), dtype=jnp.float64,
                        **kw)
    for f in tscal.VarScaler._fields:
        np.testing.assert_array_equal(getattr(port.state.scal, f).numpy(),
                                      np.asarray(getattr(ref.state.scal, f)))
    db, jdb_ = port.state.groups[0].db, ref.state.groups[0].db
    c = int(db.count)
    assert c == int(jdb_.count)
    np.testing.assert_allclose(db.data[:c].numpy(), np.asarray(jdb_.data)[:c], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(db.X[int(port.state.x_indices[0])].numpy(), port.x.numpy(),
                               rtol=1e-12)
    x0b = np.array([0.2, 1.0e3])
    port2 = mt.optimize(_scaled_mop(True, lb, ub), x0b, device="cpu", dtype=F64,
                        max_iter=8, populated_db=port)
    ref2 = jalg.optimize(_scaled_mop(False, lb, ub), jnp.asarray(x0b), dtype=jnp.float64,
                         max_iter=8, populated_db=ref)
    _assert_runs_equal(port2, ref2, 1e-9)
    assert int(port2.state.traj.x_indices[0, 0]) == c
