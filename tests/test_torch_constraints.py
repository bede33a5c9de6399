"""The port's constrained solver against the oracles and the JAX package.

At float64 on the CPU:

* ``optimize`` on the five linear-constraint configs of
  ``tests/test_oracle_parity.py`` against the sequential oracle, and on the
  six nonlinear-constraint configs of ``tests/test_oracle_full_parity.py``
  against the full oracle (integers exact, floats at those files'
  tolerances), and on the constrained golden trajectory;
* the filter functions, the normal step, the constrained descent LP and
  the constrained initial stepsize against their JAX functions on seeded
  numpy inputs, and restoration's budget rules
  (``tests/test_constraints.py:104-150``) against JAX's ``_restoration``;
* the slice configuration (two parabolas in one multiquadric RBF group,
  ``x1 + x2 <= 1``, the exact ball ``||x||^2 <= 2.25``) batched from JAX's
  initial state against JAX's batched solve, and the staged runner against
  the plain one lane by lane.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.core.algorithm as jalg
import morbit_tpu.core.descent as jdesc
import morbit_tpu.core.filter as jflt
import morbit_tpu_torch as mt
import morbit_tpu_torch.core.descent as tdesc
import morbit_tpu_torch.core.filter as tflt
import morbit_tpu_torch.parallel.multistart as tms
import morbit_tpu_torch.problems.synthetic as tsyn
import tests.test_oracle_full_parity as jfull
import tests.test_oracle_parity as jseq
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu.core.mop import MOP as JaxMOP
from morbit_tpu.core.mop import compile_mop as jax_compile_mop
from morbit_tpu.models.configs import ExactConfig as JaxExact
from morbit_tpu.models.configs import RbfConfig as JaxRbf
from morbit_tpu.utils.parity import compare_trajectories
from morbit_tpu_torch.core.algorithm import Solver
from morbit_tpu_torch.core.enums import ITER_TYPE
from morbit_tpu_torch.core.mop import compile_mop
from morbit_tpu_torch.models.configs import ExactConfig, RbfConfig
from morbit_tpu_torch.utils.carry import state_from_numpy, state_to_numpy
from morbit_tpu_torch.utils.logging import trajectory_arrays
from morbit_tpu_torch.utils.parity import export_trajectory
from tests.oracle_full import solve_oracle_full
from tests.oracle_sequential import solve_oracle

F64 = torch.float64
LB2, UB2 = [-4.0, -4.0], [4.0, 4.0]


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _parabolas(model_cfg=None):
    mop = mt.MOP(LB2, UB2)
    if model_cfg is None:
        mop.add_exact_objective(lambda x: torch.sum((x - 1.0) ** 2))
        mop.add_exact_objective(lambda x: torch.sum((x + 1.0) ** 2))
    else:
        mop.add_objective(lambda x: torch.sum((x - 1.0) ** 2), model_cfg=model_cfg)
        mop.add_objective(lambda x: torch.sum((x + 1.0) ** 2), model_cfg=model_cfg)
    return mop


# --------------------------------------------------------- oracles, golden

LIN_CASES = ("lin-active", "lin-infeasible-start", "lin-two-rows", "lin-restoration",
             "lin-infeasible-exit")


@pytest.mark.parametrize("label", LIN_CASES)
def test_linear_constraints_match_oracle(label):
    """The linear-constraint configs of tests/test_oracle_parity.py: normal
    step, compatibility, linear restoration and the INFEASIBLE exit."""
    make, x0_override, kw, tol = jseq.CASES[label]
    _, F, J, lb, ub, x0 = make()
    x0 = np.asarray(x0_override if x0_override is not None else x0, float)
    kw = dict(kw)
    A_ineq, b_ineq = kw.pop("A_ineq"), kw.pop("b_ineq")
    mop = _parabolas()
    mop.add_ineq_constraint(np.asarray(A_ineq, float), np.asarray(b_ineq, float))
    res = mt.optimize(mop, x0, device="cpu", dtype=F64, **kw)
    orc = solve_oracle(F, J, lb, ub, x0, A_ineq=A_ineq, b_ineq=b_ineq, **kw)
    tr = trajectory_arrays(res)
    assert int(res.stop_code) == orc.stop_code
    assert int(res.n_iterations) == orc.n_iterations
    for st in res.state.groups:
        assert int(st.n_evals) == orc.n_evals
    assert tr["it_stat"].tolist() == orc.traj_it_stat
    for col in tr["x_indices"].T:
        assert col.tolist() == orc.traj_x_index
    for name in ("x", "fx", "delta", "rho", "omega", "steplength"):
        a = np.asarray(tr[name], float)
        b = np.asarray(getattr(orc, "traj_" + name), float)
        assert a.shape == b.shape, name
        fin_a, fin_b = np.isfinite(a), np.isfinite(b)
        assert np.array_equal(fin_a, fin_b), name
        assert np.array_equal(a[~fin_a], b[~fin_b], equal_nan=True), name
        err = float(np.max(np.abs(a[fin_a] - b[fin_b]), initial=0.0))
        assert err <= tol, (name, err)


_CONS = {"ball": lambda x: torch.sum(x ** 2) - 2.25,
         "offball": lambda x: torch.sum((x - torch.tensor([0.0, 1.5], dtype=x.dtype)) ** 2)
         - 1.0,
         "sine": lambda x: x[1] - torch.sin(3.0 * x[0]) - 0.1}
#: label: (constraint, with the linear row x1 + x2 <= 1, RBF-modelled
#: constraint) of the port's problem; the oracle's groups, start and budget
#: come from tests/test_oracle_full_parity.py
NL_CASES = {"nl-ball": ("ball", False, False),
            "nl-restoration-vr": ("ball", False, False),
            "nl-filter-fail": ("offball", False, False),
            "nl-filter-mix": ("sine", False, False),
            "nl-lin-mix": ("ball", True, False),
            "nl-rbf-constraint": ("ball", False, True)}


@pytest.mark.parametrize("label", NL_CASES)
def test_nl_constraints_match_full_oracle(label):
    """The nonlinear-constraint configs of the full oracle: restoration,
    the variable-radius normal step, filter additions and failures, linear
    and nonlinear rows in one LP, an RBF-modelled constraint."""
    make, kw = jfull.CASES[label]
    kw = dict(kw)
    tol = kw.pop("tol")
    tol_overrides = kw.pop("tol_overrides", {})
    require = kw.pop("_require", ())
    _, groups, lb, ub, x0 = make()
    con, lin, rbf = NL_CASES[label]
    mop = _parabolas()
    cfg = RbfConfig(kernel="multiquadric", max_model_points=3) if rbf else ExactConfig()
    mop.add_nl_ineq_constraint(_CONS[con], model_cfg=cfg)
    if lin:
        mop.add_ineq_constraint([[1.0, 1.0]], [1.0])
    skw = {k: v for k, v in kw.items() if k not in ("A_ineq", "b_ineq")}
    res = mt.optimize(mop, x0, device="cpu", dtype=F64, **skw)
    orc = solve_oracle_full(lb, ub, groups, x0, **kw)
    jfull._assert_parity(res, orc, tol, tol_overrides, require)


def test_constrained_golden():
    """BASELINE config 4 (linear + nonlinear inequality, filter and
    restoration) against ``tests/golden/constrained_filter_f64.json``."""
    mop = tsyn.make_constrained_two_parabolas()
    res = mt.optimize(mop, np.array([-3.0, 2.5]), device="cpu", dtype=F64, max_iter=25)
    doc = export_trajectory(res)
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "constrained_filter_f64.json")) as f:
        golden = json.load(f)
    rep = compare_trajectories(doc, golden, x_tol=1e-10)
    assert rep["parity"], rep
    assert "RESTORATION" in doc["it_stat"]


# ---------------------------------------------------------------- components

@pytest.mark.parametrize("mode,f_dim", [("max", 1), ("strict", 2)])
def test_filter_matches_jax(mode, f_dim):
    """Constraint and objective values, envelope-shifted inserts (one
    dropped by overflow) and both acceptability tests, lane by lane."""
    rng = np.random.default_rng(3)
    B, cap, shift = 6, 4, 1e-4
    blocks = [rng.normal(size=(B, k)) for k in (1, 2, 0, 1)]
    fx = rng.normal(size=(B, 2))
    theta = tflt.compute_constraint_val(*(_t(b) for b in blocks))
    jtheta = jax.vmap(jflt.compute_constraint_val)(*(jnp.asarray(b) for b in blocks))
    np.testing.assert_array_equal(theta.numpy(), np.asarray(jtheta))
    f = tflt.compute_objective_val(_t(fx), mode)
    np.testing.assert_array_equal(f.numpy(), np.asarray(
        jax.vmap(lambda v: jflt.compute_objective_val(v, mode))(jnp.asarray(fx))))

    filt = tflt.init_filter(B, cap, f_dim, F64, "cpu")
    jfilt = jflt.init_filter(cap, f_dim, jnp.float64)
    jfilt = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jfilt)
    jadd = jax.vmap(jflt.add_entry, in_axes=(0, 0, 0, None))
    for k in range(cap + 1):                 # the last insert overflows
        th = np.abs(rng.normal(size=B))
        fv = rng.normal(size=(B, f_dim))
        do = rng.uniform(size=B) < 0.8 if k else np.ones(B, bool)
        new = tflt.add_entry(filt, _t(th), _t(fv), shift)
        filt = tflt.FilterState(*(torch.where(torch.as_tensor(do).reshape(
            (B,) + (1,) * (a.dim() - 1)), a, b) for a, b in zip(new, filt)))
        jnew = jadd(jfilt, jnp.asarray(th), jnp.asarray(fv), jnp.asarray(shift))
        jfilt = jax.tree_util.tree_map(lambda a, b: jnp.where(
            jnp.asarray(do).reshape((B,) + (1,) * (a.ndim - 1)), a, b), jnew, jfilt)
    for a, b in zip(filt, jfilt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(filt.overflow.any())
    th = np.abs(rng.normal(size=B))
    fv = rng.normal(size=(B, f_dim))
    th_k, f_k = np.abs(rng.normal(size=B)), rng.normal(size=(B, f_dim))
    np.testing.assert_array_equal(
        tflt.is_acceptable(filt, _t(th), _t(fv)).numpy(),
        np.asarray(jax.vmap(jflt.is_acceptable)(jfilt, jnp.asarray(th), jnp.asarray(fv))))
    np.testing.assert_array_equal(
        tflt.is_acceptable_vs(filt, _t(th), _t(fv), _t(th_k), _t(f_k), shift).numpy(),
        np.asarray(jax.vmap(jflt.is_acceptable_vs, in_axes=(0, 0, 0, 0, 0, None))(
            jfilt, jnp.asarray(th), jnp.asarray(fv), jnp.asarray(th_k),
            jnp.asarray(f_k), jnp.asarray(shift))))


def _lin_rows(rng, B, n, p, q, x, infeasible=False):
    """Row-equilibrated constraint rows with right-hand sides at ``x``: a
    random step from x satisfies them, unless ``infeasible`` (the first
    inequality row then asks for a step past the unit box)."""
    A_eq = rng.normal(size=(B, p, n))
    A_ineq = rng.normal(size=(B, q, n))
    s = rng.uniform(-0.1, 0.1, (B, n))
    b_eq = np.einsum("bpn,bn->bp", A_eq, s)
    b_ineq = np.einsum("bqn,bn->bq", A_ineq, s) + np.abs(rng.normal(size=(B, q)))
    if infeasible:
        A_ineq[:, 0] = 0.0
        A_ineq[:, 0, 0] = 1.0
        b_ineq[:, 0] = -2.0 - x[:, 0]          # x + n <= -2 outside [0, 1]
    eq = lambda A, b: (A / np.abs(A).max(-1, keepdims=True),
                       b / np.abs(A).max(-1))
    return eq(A_eq, b_eq) + eq(A_ineq, b_ineq)


def _jax_lin(rows):
    return jdesc.LinearizedConstraints(*(jnp.asarray(a) for a in rows))


@pytest.mark.parametrize("case", ["fixed_radius", "variable_radius", "mixed", "infeasible"])
def test_normal_step_matches_jax(case):
    """The normal step (K1's (4, 11)-type LP with equality rows and rows
    with an infinite upper bound) per lane against JAX's, with
    ``variable_radius`` False, True and mixed over lanes; an infeasible row
    set gives NaN and ``feasible`` False in both."""
    rng = np.random.default_rng({"fixed_radius": 0, "variable_radius": 1,
                                 "mixed": 2, "infeasible": 3}[case])
    B, n = 8, 2
    x = rng.uniform(0.2, 0.8, (B, n))
    rows = _lin_rows(rng, B, n, 1, 2, x, infeasible=case == "infeasible")
    vr = {"fixed_radius": np.zeros(B, bool), "variable_radius": np.ones(B, bool),
          "mixed": np.arange(B) % 2 == 0, "infeasible": np.arange(B) % 2 == 0}[case]
    delta = rng.uniform(0.05, 0.4, B)
    lb, ub = np.zeros((B, n)), np.ones((B, n))
    n_p, d_p, ok_p = tdesc.normal_step(_t(x), _t(lb), _t(ub),
                                       tdesc.LinearizedConstraints(*(_t(a) for a in rows)),
                                       0.7, 0.5, _t(delta), torch.as_tensor(vr))
    n_j, d_j, ok_j = jax.vmap(lambda *a: jdesc.normal_step(
        a[0], a[1], a[2], jdesc.LinearizedConstraints(*a[3:7]), 0.7, 0.5, a[7], a[8]))(
        *(jnp.asarray(a) for a in (x, lb, ub, *rows, delta, vr)))
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(n_p.numpy(), np.asarray(n_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=0, atol=1e-10)
    if case == "infeasible":
        assert not ok_p.any() and torch.isnan(n_p).all()
    else:
        assert ok_p.all()


def test_descent_lp_with_constraint_rows_matches_jax():
    """The steepest-descent LP with equality and inequality rows (K1's
    (3, 8)-type shape plus an equality row) against JAX's."""
    rng = np.random.default_rng(4)
    B, n = 8, 2
    x = rng.uniform(0.2, 0.8, (B, n))
    Dm = rng.normal(size=(B, 2, n)) * 8.0
    rows = _lin_rows(rng, B, n, 1, 2, x)
    lb, ub = np.zeros((B, n)), np.ones((B, n))
    d_p, om_p = tdesc.steepest_descent_direction(
        _t(x), _t(Dm), _t(lb), _t(ub), tdesc.LinearizedConstraints(*(_t(a) for a in rows)))
    d_j, om_j = jax.vmap(lambda *a: jdesc.steepest_descent_direction(
        a[0], a[1], a[2], a[3], jdesc.LinearizedConstraints(*a[4:])))(
        *(jnp.asarray(a) for a in (x, Dm, lb, ub, *rows)))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(om_p.numpy(), np.asarray(om_j), rtol=0, atol=1e-10)
    assert torch.isfinite(om_p).all()


def test_initial_stepsize_constraint_rows_match_jax():
    """The Delta > 1 sigma search with constraint rows
    (``tests/test_constraints.py:153-181``): a binding row, a loose one,
    and one the ray moves away from, against JAX's."""
    x = np.zeros((4, 2))
    d = np.tile([1.0, 0.0], (4, 1))
    lb, ub = np.full((4, 2), -10.0), np.full((4, 2), 10.0)
    delta = np.full(4, 2.0)
    vals = np.array([[0.0], [0.0], [0.0], [0.0]])
    dirs = np.array([[1.0], [1.0], [-1.0], [0.0]])
    rhs = np.array([[0.5], [7.0], [0.5], [0.5]])
    s_p = tdesc.initial_stepsize(*(_t(a) for a in (x, x, d, delta, lb, ub, vals, dirs, rhs)))
    s_j = jax.vmap(lambda *a: jdesc.initial_stepsize(*a[:6], jnp.float64, *a[6:]))(
        *(jnp.asarray(a) for a in (x, x, d, delta, lb, ub, vals, dirs, rhs)))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(s_p.numpy(), [0.5, 2.0, 2.0, 2.0])


def _restoration_pair(**ac_kw):
    """Port and JAX solvers with an infeasible initial state at (3, 3) for
    direct ``_restoration`` calls (``tests/test_constraints.py:87-100``)."""
    port = _parabolas()
    port.add_nl_ineq_constraint(lambda x: torch.sum(x ** 2) - 1.0, model_cfg=ExactConfig())
    ref = JaxMOP(LB2, UB2)
    ref.add_exact_objective(lambda x: jnp.sum((x - 1.0) ** 2))
    ref.add_exact_objective(lambda x: jnp.sum((x + 1.0) ** 2))
    ref.add_nl_ineq_constraint(lambda x: jnp.sum(x ** 2) - 1.0, model_cfg=JaxExact())
    solver = Solver(compile_mop(port), mt.AlgorithmConfig(**ac_kw), F64, "cpu")
    jsolver = jalg.Solver(jax_compile_mop(ref), JaxConfig(**ac_kw), jnp.float64)
    st = solver.initialize(np.array([3.0, 3.0]))
    jst = jsolver.initialize(jnp.array([3.0, 3.0]))
    out = solver._restoration(st, solver._theta(st), torch.full((1, 2), float("nan"),
                                                                dtype=F64),
                              torch.ones(1, dtype=torch.bool))
    jout = jax.jit(lambda s: jsolver._restoration(s, jsolver._theta(s),
                                                  jnp.full((2,), jnp.nan)))(jst)
    np.testing.assert_allclose(out.x[0].numpy(), np.asarray(jout.x), rtol=0, atol=1e-12)
    assert ([int(g.n_evals[0]) for g in out.groups]
            == [int(g.n_evals) for g in jout.groups])
    assert int(out.last_it_stat[0]) == int(jout.last_it_stat)
    assert int(out.stop_code[0]) == int(jout.stop_code)
    return solver, st, out


@pytest.mark.parametrize("budget", ["stopval", "max_evals", "max_restoration_evals"])
def test_restoration_budget_matches_jax(budget):
    """Restoration's budget rules (``algorithm.jl:368-385``), as
    ``tests/test_constraints.py:104-150`` check them in the JAX package:
    the ``stopval`` exit at theta zero far below 500 n evaluations; the
    cap at the remaining per-function budget; and ``max_restoration_evals``
    capping the solve with its counting suspended."""
    kw = {"stopval": {}, "max_evals": dict(max_evals=10),
          "max_restoration_evals": dict(max_restoration_evals=7)}[budget]
    solver, st, out = _restoration_pair(**kw)
    before = int(st.groups[2].n_evals[0])
    after = int(out.groups[2].n_evals[0])
    if budget == "stopval":
        assert float(solver._theta(out)[0]) <= 10 * np.finfo(np.float64).eps
        assert 1 <= after - before < 100          # +1: the evaluation at x_r
        assert int(out.last_it_stat[0]) == ITER_TYPE.RESTORATION
    elif budget == "max_evals":
        assert after <= 10 + 1
    else:
        assert after == before + 1


# ------------------------------------------------------ the slice, batched

#: the slice's budget at B=8; the batch held leaf for leaf against JAX
#: starts from Halton index 10, the one that pins ROADMAP 3.6 from index 20
SLICE_KW = dict(max_iter=10)
SLICE_START = 10
#: from Halton index 20, lane 4's database holds its iterate twice (a
#: restoration that stayed at x); round 4's tau^2 of that duplicate is
#: rounding noise tested against 1e-28 (ROADMAP 3.6), and at this trip JAX
#: accepts it (its fit turns NaN and the lane stops CRITICAL) where the
#: port's round 4 rejects it
DUPLICATE_START, DUPLICATE_LANE, DUPLICATE_TRIP = 20, 4, 3


def _jax_slice_mop():
    mop = JaxMOP(LB2, UB2)
    cfg = JaxRbf(kernel="multiquadric")
    mop.add_objective(lambda x: jnp.sum((x - 1.0) ** 2), model_cfg=cfg)
    mop.add_objective(lambda x: jnp.sum((x + 1.0) ** 2), model_cfg=cfg)
    mop.add_ineq_constraint([[1.0, 1.0]], [1.0])
    mop.add_nl_ineq_constraint(lambda x: jnp.sum(x ** 2) - 2.25, model_cfg=JaxExact())
    return mop


def _slice_mop():
    return tsyn.make_constrained_two_parabolas(RbfConfig(kernel="multiquadric"))


def jax_state_leaves(st):
    """A JAX ``SolverState`` as ``utils/carry.state_from_numpy``'s dict;
    groups with an RBF model also carry it."""
    out = {f: np.asarray(getattr(st, f))
           for f in ("x", "x_s", "fx", "l_e", "l_i", "c_e", "c_i", "dlt", "ints")}
    out["traj.data"] = np.asarray(st.traj.data)
    out["traj.count"] = np.asarray(st.traj.count)
    for f in ("scale", "offset", "lb_scaled", "ub_scaled"):
        out[f"scal.{f}"] = np.asarray(getattr(st.scal, f))
    for f in ("theta", "fvals", "count", "overflow"):
        out[f"filter.{f}"] = np.asarray(getattr(st.filter, f))
    for i, g in enumerate(st.groups):
        for f in ("data", "count", "overflow"):
            out[f"groups.{i}.db.{f}"] = np.asarray(getattr(g.db, f))
        out[f"groups.{i}.n_evals"] = np.asarray(g.n_evals)
        if hasattr(g.model, "meta"):
            out[f"groups.{i}.model.meta"] = np.asarray(g.model.meta)
            out[f"groups.{i}.model.dirs"] = np.asarray(g.model.dirs)
            out[f"groups.{i}.model.fit.fdata"] = np.asarray(g.model.fit.fdata)
            out[f"groups.{i}.model.fit.flam"] = np.asarray(g.model.fit.flam)
    return out


@pytest.fixture(scope="module")
def jax_slice():
    """JAX's batched solve of the slice at B=8 and its initial state."""
    starts = tsyn.halton_starts(8, LB2, UB2, start_index=SLICE_START)
    jsolver = jalg.Solver(jax_compile_mop(_jax_slice_mop()), JaxConfig(**SLICE_KW),
                          jnp.float64)
    init = jax.jit(jax.vmap(jsolver.initialize))(jnp.asarray(starts))
    ref = jax.jit(jax.vmap(jsolver.solve_from_state))(init)
    return starts, jax_state_leaves(init), jax_state_leaves(ref)


def _states_apart(port_leaves, ref_leaves, tol, allowed=None, rtol=0.0):
    """Every leaf, lane by lane: integers exact, floats within ``tol`` +
    ``rtol`` |x|, except two that are conditioned far worse than the iterates: the RBF
    fit coefficients (within 1e-7 relative) and the stamped rho, a ratio
    of differences of nearly equal model values (within 1e-4 relative, as
    in the RBF carried-state test). Asserts that no lane outside
    ``allowed`` (B,) parts; returns the (B,) mask of the lanes that part."""
    assert set(port_leaves) == set(ref_leaves)
    B = ref_leaves["x"].shape[0]
    allowed = np.zeros(B, bool) if allowed is None else allowed
    apart = np.zeros(B, bool)
    for name, a in port_leaves.items():
        b = ref_leaves[name]
        close = lambda x, y, rtol: np.isclose(x, y, rtol=rtol, atol=tol, equal_nan=True
                                              ).reshape(B, -1).all(-1)
        if a.dtype.kind in "biu":
            bad = (a != b).reshape(B, -1).any(-1)
        elif ".fit." in name:
            bad = ~np.isclose(a, b, rtol=1e-7, atol=1e-9, equal_nan=True).reshape(B, -1).all(-1)
        elif name == "traj.data":
            rho = 2 + 2 + 1                       # n + m_obj + 1
            bad = ~(close(np.delete(a, rho, -1), np.delete(b, rho, -1), rtol)
                    & close(a[..., rho], b[..., rho], 1e-4))
        else:
            bad = ~close(a, b, rtol)
        lanes = np.nonzero(bad & ~allowed)[0]
        assert lanes.size == 0, (name, lanes, a[lanes], b[lanes])
        apart |= bad
    return apart


@pytest.mark.parametrize("runner", ["plain", "staged"])
def test_slice_batched_matches_jax(jax_slice, runner):
    """The slice at B=8 from JAX's initial state (carried with
    ``state_from_numpy``, filter included) against JAX's batched solve,
    every leaf of the final state; the staged runner (schedule (3, 6),
    widths (8, 4, 2)) as well."""
    starts, init, ref = jax_slice
    state = state_from_numpy(init, device="cpu")
    if runner == "plain":
        solver = Solver(compile_mop(_slice_mop()), mt.AlgorithmConfig(**SLICE_KW), F64,
                        "cpu")
        final, _ = solver.solve_from_state(state)
    else:
        final = tms.StagedMultistart(_slice_mop(), mt.AlgorithmConfig(**SLICE_KW), F64,
                                     schedule=(3, 6), widths=(8, 4, 2), device="cpu",
                                     ).solve_from_state(state).state
        final = tms.canonicalize_buffer_tails(final)
    assert not _states_apart(state_to_numpy(final), ref, 1e-10).any()
    assert int(final.filter.count.max()) > 0
    assert (final.traj.it_stat == ITER_TYPE.RESTORATION).any()


def test_slice_duplicate_site_parts_one_lane():
    """ROADMAP 3.6 pinned: the slice at B=8 from Halton index 20, the port
    and JAX each run trip by trip from JAX's initial state. Every lane but
    lane 4 equals JAX after every trip, integers exact and floats within
    1e-10 + 1e-9 |x| (from trip 7 on, lane 5's radius, 0.1436, differs by
    1.66e-10: it is set from an accepted step of length 7.2e-5 whose
    rounding, 8e-14, is 1.2e-9 of it), and lane 4 parts exactly at trip 3,
    starting it with its iterate twice in its database."""
    from morbit_tpu.core.enums import STOP_CODE as JAX_STOP_CODE
    from morbit_tpu_torch.core.enums import STOP_CODE
    from morbit_tpu_torch.utils.tree import tree_where

    starts = tsyn.halton_starts(8, LB2, UB2, start_index=DUPLICATE_START)
    jsolver = jalg.Solver(jax_compile_mop(_jax_slice_mop()), JaxConfig(**SLICE_KW),
                          jnp.float64)
    jstate = jax.jit(jax.vmap(jsolver.initialize))(jnp.asarray(starts))
    jstep = jax.jit(jax.vmap(lambda s: jax.lax.cond(
        s.stop_code == JAX_STOP_CODE.CONTINUE, jsolver.iterate, lambda s: s, s)))
    solver = Solver(compile_mop(_slice_mop()), mt.AlgorithmConfig(**SLICE_KW), F64, "cpu")
    state = state_from_numpy(jax_state_leaves(jstate), device="cpu")
    lane = np.arange(8) == DUPLICATE_LANE
    first_apart, trip = {}, 0
    while (bool((state.stop_code == STOP_CODE.CONTINUE).any())
           or bool((jstate.stop_code == JAX_STOP_CODE.CONTINUE).any())):
        if trip == DUPLICATE_TRIP:
            X = state.groups[0].db.X[DUPLICATE_LANE]
            rows = X[: int(state.groups[0].db.count[DUPLICATE_LANE])]
            assert (rows == state.x_s[DUPLICATE_LANE]).all(-1).sum() == 2
        running = state.stop_code == STOP_CODE.CONTINUE
        state = tree_where(running, solver.iterate(state), state)
        jstate = jstep(jstate)
        apart = _states_apart(state_to_numpy(state), jax_state_leaves(jstate), 1e-10,
                              allowed=lane & (trip >= DUPLICATE_TRIP), rtol=1e-9)
        for i in np.nonzero(apart)[0]:
            first_apart.setdefault(int(i), trip)
        trip += 1
    assert first_apart == {DUPLICATE_LANE: DUPLICATE_TRIP}


@pytest.fixture(scope="module")
def plain_slice():
    x0 = tsyn.halton_starts(8, LB2, UB2)
    return x0, tms.multistart_optimize(_slice_mop(), x0, mt.AlgorithmConfig(**SLICE_KW),
                                       dtype=F64, device="cpu")


@pytest.mark.parametrize("widths", [None, (4, 1), (8, 4, 4)])
def test_slice_staged_matches_plain(plain_slice, widths):
    """``StagedMultistart`` on the slice (capacity stages, the fleet loop,
    compacted and starving widths) equals the plain runner lane by lane:
    integers exact, floats within 1e-12; the filter, the constraint values
    and the restoration counters are selected per trip like any small
    leaf."""
    x0, ref = plain_slice
    res = tms.StagedMultistart(_slice_mop(), mt.AlgorithmConfig(**SLICE_KW), F64,
                               schedule=(3, 6), widths=widths, device="cpu")(x0)
    a = state_to_numpy(tms.canonicalize_buffer_tails(res.state))
    b = state_to_numpy(tms.canonicalize_buffer_tails(ref.state))
    assert a.keys() == b.keys()
    for name in a:
        if a[name].dtype.kind in "biu":
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        else:
            np.testing.assert_allclose(a[name], b[name], rtol=0, atol=1e-12, err_msg=name)
    assert (ref.stop_code == 6).sum() + (ref.state.filter.count > 0).sum() > 0
