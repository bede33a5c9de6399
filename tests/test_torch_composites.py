"""Composite functions in the PyTorch port against the JAX package.

A composite ``phi(x, g(x))`` has a cheap known outer ``phi`` over an
expensive modelled inner ``g`` (``MOP.add_function``). At float64 on the
CPU: ``compile_mop``'s structure equals JAX's; the container's composite
values and Jacobians equal JAX's on one carried state within 1e-12; JAX's
own composite tests hold; the oracle configs composite-rbf (1e-8) and
composite-nl (1e-9) hold; a batched composite solve with a composite
constraint equals JAX's batched solve from JAX's initial state within
1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.core.algorithm as jalg
import morbit_tpu_torch as mt
import morbit_tpu_torch.parallel.multistart as tms
import morbit_tpu_torch.problems.synthetic as tsyn
import tests.test_oracle_full_parity as jfull
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu.core.mop import MOP as JaxMOP
from morbit_tpu.core.mop import compile_mop as jax_compile_mop
from morbit_tpu.models.configs import ExactConfig as JaxExact
from morbit_tpu.models.configs import RbfConfig as JaxRbf
from morbit_tpu_torch.core.algorithm import Solver
from morbit_tpu_torch.core.mop import INNER, compile_mop
from morbit_tpu_torch.models.configs import ExactConfig, RbfConfig
from morbit_tpu_torch.utils.carry import state_from_numpy, state_to_numpy
from tests.oracle_full import solve_oracle_full
from tests.test_torch_constraints import _states_apart, jax_state_leaves

F64 = torch.float64
LB2, UB2 = [-2.0, -2.0], [2.0, 2.0]
A = 1.0


def _mods(port):
    return (mt.MOP, torch, RbfConfig, ExactConfig) if port else (JaxMOP, jnp, JaxRbf, JaxExact)


def mixed_mop(port):
    """Every kind of entry in a mixed addition order: an exact objective, an
    RBF inner function, a composite objective over it as a string, the same
    inner callable registered again (a duplicate, resolved to its canonical
    slot), a composite inequality and a composite equality over the
    duplicate, an RBF constraint and a second inner function whose
    composite objective makes its group count toward the budget."""
    MOP, s, Rbf, Exact = _mods(port)
    mop = MOP(LB2, UB2)
    inner = lambda x: s.stack([x[0] * x[1], x[0] + x[1]])
    mop.add_exact_objective(lambda x: s.sum((x - 1.0) ** 2))
    g = mop.add_function(inner, n_out=2, model_cfg=Rbf(kernel="cubic"))
    mop.add_composite_objective("x[0] + jnp.sum(g**2)", g)
    g2 = mop.add_function(inner, n_out=2, model_cfg=Rbf(kernel="cubic"))
    mop.add_composite_nl_ineq_constraint(lambda x, v: v[0] - 1.0, g2)
    mop.add_nl_ineq_constraint(lambda x: s.sum(x ** 2) - 3.0, model_cfg=Rbf(kernel="cubic"))
    mop.add_composite_nl_eq_constraint(lambda x, v: s.stack([v[1] - x[0], v[0]]), g2,
                                       n_out=2)
    h = mop.add_function(lambda x: (x[1] - 0.5) ** 2, model_cfg=Exact())
    mop.add_composite_objective(lambda x, v: v[0] + x[0], h)
    return mop


def _structure(cmop):
    groups = [(g.index, g.m, g.has_objective, g.max_evals,
               [(mb.fn_index, mb.group_offset, mb.global_offset, mb.n_out, mb.role)
                for mb in g.members]) for g in cmop.groups]
    comps = [(c.role, c.global_offset, c.n_out, c.group_index, c.group_offset, c.width)
             for c in cmop.composites]
    return (cmop.m_obj, cmop.m_ce, cmop.m_ci, groups, comps)


def test_compile_mop_structure_matches_jax():
    """Offsets (in the combined order of functions and composites), group
    indices and offsets, widths, ``has_objective`` (a group feeding a
    composite objective counts), duplicates and the inner role equal JAX's;
    an expression string evaluates with ``jnp`` bound to torch."""
    port, ref = compile_mop(mixed_mop(True)), jax_compile_mop(mixed_mop(False))
    assert _structure(port) == _structure(ref)
    assert any(mb.role == INNER for g in port.groups for mb in g.members)
    assert port.composites[0].group_index == port.composites[1].group_index
    x, g = np.array([0.3, -0.7]), np.array([1.5, -2.0])
    for cs, jcs in zip(port.composites, ref.composites):
        got = cs.eval(torch.as_tensor(x), torch.as_tensor(g[: cs.width])).numpy()
        want = np.atleast_1d(np.asarray(jcs.outer(jnp.asarray(x), jnp.asarray(g[: cs.width]))))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    with pytest.raises(ValueError):
        mt.MOP(LB2, UB2).add_composite_objective("g[0]", 0)


def test_container_composites_match_jax():
    """On one batched state carried from JAX (B=4, RBF inner group, exact
    constraint group): the container's objective and constraint values and
    Jacobians at the iterates and at shifted sites, and the counted
    evaluations of the exact group, equal JAX's within 1e-12."""
    starts = tsyn.halton_starts(4, LB2, UB2, start_index=3)
    jsolver = jalg.Solver(jax_compile_mop(mixed_mop(False)), JaxConfig(), jnp.float64)
    jst = jax.jit(jax.vmap(jsolver.initialize))(jnp.asarray(starts))
    solver = Solver(compile_mop(mixed_mop(True)), mt.AlgorithmConfig(), F64, "cpu")
    st = state_from_numpy(jax_state_leaves(jst), device="cpu")
    rng = np.random.default_rng(7)
    shift = rng.uniform(-0.05, 0.05, st.x_s.shape)
    c, jc = solver.container, jsolver.container
    for xq in (np.asarray(jst.x_s), np.asarray(jst.x_s) + shift):
        xt = torch.as_tensor(xq)
        for name in ("eval_objectives", "eval_nl_eq", "eval_nl_ineq"):
            got, groups = getattr(c, name)(st.groups, xt, st.scal)
            want, jgroups = jax.jit(jax.vmap(lambda g, x, s: getattr(jc, name)(g, x, s)))(
                jst.groups, jnp.asarray(xq), jst.scal)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
            assert [g.n_evals.tolist() for g in groups] == [
                np.asarray(g.n_evals).tolist() for g in jgroups]
        for name in ("jac_objectives", "jac_nl_eq", "jac_nl_ineq", "jac_all"):
            got = getattr(c, name)(st.groups, xt, st.scal)
            want = jax.jit(jax.vmap(lambda g, x, s: getattr(jc, name)(g, x, s)))(
                jst.groups, jnp.asarray(xq), jst.scal)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    # the true values at the iterates: evaluate_true scatters composites too
    fx, c_e, c_i, _, _ = c.evaluate_true(st.groups, st.x_s, st.scal)
    for got, want in zip((fx, c_e, c_i), (jst.fx, jst.c_e, jst.c_i)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


# JAX's tests/test_composites.py, case by case, on the port and beside JAX


def _shared_inner_mop(port):
    MOP, s, Rbf, _ = _mods(port)
    mop = MOP(LB2, UB2)
    g = mop.add_function(lambda x: s.stack([x[0] - 1.0, x[1] + 1.0]), n_out=2,
                         model_cfg=Rbf(kernel="cubic"))
    mop.add_composite_objective(lambda x, v: s.sum(v ** 2) + 0.1 * x[0], g)
    mop.add_composite_objective(lambda x, v: (v[0] - 2.0) ** 2 + v[1] ** 2, g)
    return mop


def _nl_composite_mop(port):
    MOP, s, _, Exact = _mods(port)
    mop = MOP(LB2, UB2)
    mop.add_exact_objective(lambda x: s.sum((x - 1.0) ** 2))
    mop.add_exact_objective(lambda x: s.sum((x + 1.0) ** 2))
    g = mop.add_function(lambda x: s.sum(x ** 2).reshape(1), n_out=1, model_cfg=Exact())
    mop.add_composite_nl_ineq_constraint(lambda x, v: v[0] - 1.0, g)
    return mop


@pytest.mark.parametrize("case", ["shared_inner", "nl_constraint"])
def test_jax_composite_cases(case):
    """``test_composite_objectives_share_inner_function`` and
    ``test_composite_nl_constraint``: their assertions on the port, and the
    port's run equal to JAX's (integers exact, floats within 1e-9)."""
    build, x0, kw = {"shared_inner": (_shared_inner_mop, [1.5, -1.5], dict(max_iter=15)),
                     "nl_constraint": (_nl_composite_mop, [1.5, 1.5], dict(max_iter=20))}[case]
    port = mt.optimize(build(True), x0, device="cpu", dtype=F64, **kw)
    ref = jalg.optimize(build(False), jnp.asarray(x0), dtype=jnp.float64, **kw)
    x = port.x.numpy()
    assert np.all(np.isfinite(x))
    if case == "shared_inner":
        cmop = compile_mop(build(True))
        assert cmop.m_obj == 2 and len(cmop.composites) == 2
        assert cmop.composites[0].group_index == cmop.composites[1].group_index
        assert abs(x[1] + 1.0) < 0.2 and int(port.n_evals) <= 30
    else:
        assert float(np.sum(x ** 2)) <= 1.0 + 1e-4
    assert int(port.stop_code) == int(ref.stop_code)
    assert int(port.n_iterations) == int(ref.n_iterations)
    assert [int(g.n_evals) for g in port.state.groups] == [
        int(g.n_evals) for g in ref.state.groups]
    np.testing.assert_allclose(x, np.asarray(ref.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(port.fx.numpy(), np.asarray(ref.fx), rtol=0, atol=1e-9)


def test_composite_surrogate_values_and_jacobian():
    """``test_composite_surrogate_values_and_jacobian``: with an exact inner
    model the container's composite value and Jacobian are the truth's."""
    mop = mt.MOP(LB2, UB2)
    g = mop.add_function(lambda x: torch.stack([x[0] * x[1], x[0] + x[1]]), n_out=2,
                         model_cfg=ExactConfig())
    mop.add_composite_objective(lambda x, v: v[0] ** 2 + 2.0 * v[1] + x[1], g)
    solver = Solver(compile_mop(mop), mt.AlgorithmConfig(), F64, "cpu")
    st = solver.initialize(torch.tensor([0.5, -0.3], dtype=F64))

    def truth(xs):
        xu = (xs - st.scal.offset[0]) / st.scal.scale[0]
        v = torch.stack([xu[0] * xu[1], xu[0] + xu[1]])
        return v[0] ** 2 + 2.0 * v[1] + xu[1]

    mx, _ = solver.container.eval_objectives(st.groups, st.x_s, st.scal)
    assert abs(float(mx[0, 0]) - float(truth(st.x_s[0]))) <= 1e-10
    J = solver.container.jac_objectives(st.groups, st.x_s, st.scal)
    J_true = torch.func.grad(truth)(st.x_s[0])
    np.testing.assert_allclose(J[0, 0].numpy(), J_true.numpy(), rtol=0, atol=1e-8)


def _oracle_port_mop(case):
    """The port's MOP of the full oracle's composite configurations."""
    mop = mt.MOP(LB2, UB2)
    cfg = RbfConfig(kernel="cubic", max_model_points=3)
    g = mop.add_function(lambda x: torch.stack([x[0] - 1.0, x[1] + 1.0]), n_out=2,
                         model_cfg=cfg)
    mop.add_composite_objective(lambda x, v: torch.sum(v ** 2) + 0.1 * x[0], g)
    mop.add_composite_objective(lambda x, v: (v[0] - 2.0) ** 2 + v[1] ** 2, g)
    if case == "composite-nl":
        mop.add_nl_ineq_constraint(lambda x: torch.sum(x ** 2) - 2.0, model_cfg=ExactConfig())
    return mop


@pytest.mark.parametrize("label", ["composite-rbf", "composite-nl"])
def test_composites_match_full_oracle(label):
    """Oracle composite-rbf (into the criticality routine, 1e-8) and
    composite-nl (restoration from an infeasible start, 1e-9): structure
    exact, every stamped float within the config's tolerance."""
    make, kw = jfull.CASES[label]
    kw = dict(kw)
    tol, require = kw.pop("tol"), kw.pop("_require", ())
    _, groups, lb, ub, x0 = make()
    res = mt.optimize(_oracle_port_mop(label), x0, device="cpu", dtype=F64, **kw)
    orc = solve_oracle_full(lb, ub, groups, x0, **kw)
    jfull._assert_parity(res, orc, tol, (), require)


def _slice_mop(port):
    """``examples/composites.py`` at the main path's box: g(x) = (||x-a||^2,
    ||x+a||^2) in one cubic RBF group, objectives g0 and g1 + 0.1 x0, the
    composite constraint g0 - 9 <= 0 (``problems/synthetic.make_composite``)."""
    if port:
        return tsyn.make_composite(RbfConfig(kernel="cubic"))
    a = jnp.array([A, A])
    mop = JaxMOP([-4.0, -4.0], [4.0, 4.0])
    g = mop.add_function(lambda x: jnp.stack([jnp.sum((x - a) ** 2), jnp.sum((x + a) ** 2)]),
                         n_out=2, model_cfg=JaxRbf(kernel="cubic"))
    mop.add_composite_objective(lambda x, v: v[0], g)
    mop.add_composite_objective(lambda x, v: v[1] + 0.1 * x[0], g)
    mop.add_composite_nl_ineq_constraint(lambda x, v: v[0] - 9.0, g)
    return mop


SLICE_KW = dict(max_iter=12)


@pytest.fixture(scope="module")
def jax_slice():
    """JAX's batched solve of the composite path at B=6 and its initial
    state."""
    starts = tsyn.halton_starts(6, [-4.0, -4.0], [4.0, 4.0], start_index=1)
    jsolver = jalg.Solver(jax_compile_mop(_slice_mop(False)), JaxConfig(**SLICE_KW),
                          jnp.float64)
    init = jax.jit(jax.vmap(jsolver.initialize))(jnp.asarray(starts))
    ref = jax.jit(jax.vmap(jsolver.solve_from_state))(init)
    return jax_state_leaves(init), jax_state_leaves(ref)


@pytest.mark.parametrize("runner", ["plain", "staged"])
def test_composite_batch_matches_jax(jax_slice, runner):
    """The composite path at B=6, max_iter=12 from JAX's initial state
    (carried with ``state_from_numpy``) against JAX's batched solve, every
    leaf of the final state within 1e-10 (integers exact); the staged runner
    (schedule (3, 6), widths (6, 3, 2)) as well."""
    kw = SLICE_KW
    init, ref = jax_slice
    state = state_from_numpy(init, device="cpu")
    if runner == "plain":
        solver = Solver(compile_mop(_slice_mop(True)), mt.AlgorithmConfig(**kw), F64, "cpu")
        final, _ = solver.solve_from_state(state)
    else:
        final = tms.StagedMultistart(_slice_mop(True), mt.AlgorithmConfig(**kw), F64,
                                     schedule=(3, 6), widths=(6, 3, 2), device="cpu",
                                     ).solve_from_state(state).state
        final = tms.canonicalize_buffer_tails(final)
    assert len(final.groups) == 1
    assert not _states_apart(state_to_numpy(final), ref, 1e-10).any()
