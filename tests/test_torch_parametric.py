"""The port's ``parametric_multistart`` (one problem instance per lane, the
functions taking per-lane data θ) against the JAX package's, at float64 on
the CPU.

* JAX's two tests (``tests/test_parametric.py``, the two parabolas centred
  at ±θ in one multiquadric RBF group): from JAX's initial state (JAX's
  jitted initialization moves the last bit of the round-3 box exits, whose
  ties then part free RBF runs, ROADMAP 3.4; ``tests/test_torch_rbf.py``
  starts from it for the same reason), integers equal to JAX's
  ``parametric_multistart`` on every lane (stop code, iterations,
  evaluations), x and fx within 1e-10; the port's own free run: each lane
  near its own Pareto segment, and a lane equal to the port's ``optimize``
  of that instance (1e-12, equal evaluations);
* θ inside a nonlinear inequality constraint: see
  ``tests/test_torch_parametric_constrained.py``;
* an integer leaf of θ that selects a branch keeps its dtype, and each lane
  equals ``optimize`` of its instance;
* the static structure: a builder whose bounds, linear rows or model
  config depend on θ raises a ``ValueError`` naming the field; a host
  function raises; θ crosses ``utils/carry`` with its lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.core.algorithm as jalg
import morbit_tpu_torch as mt
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu.core.mop import compile_mop as jax_compile_mop
from morbit_tpu.parallel.multistart import parametric_multistart as jax_parametric
from morbit_tpu_torch.core.parametric import flatten, parametric_mop
from morbit_tpu_torch.models.configs import ExactConfig, RbfConfig
from morbit_tpu_torch.parallel.multistart import parametric_multistart
from morbit_tpu_torch.problems.synthetic import build_shifted
from morbit_tpu_torch.utils.carry import state_from_numpy, state_to_numpy
from test_parametric import build_shifted as jax_build_shifted
from torch_record_zdt2_f32 import jax_leaves

F64 = torch.float64
INTS = ("stop_code", "n_iterations", "n_evals")


def run_from_jax_initial(jax_builder, torch_builder, x0, theta, kw):
    """JAX's ``parametric_multistart`` and the port's parametric solver from
    JAX's initial state (its jitted, vmapped ``initialize`` of each lane's
    instance), theta crossing as the state's leaves."""
    jac = JaxConfig(**kw)
    jtheta = jax.tree_util.tree_map(jnp.asarray, theta)

    def init(x, th):
        return jalg.Solver(jax_compile_mop(jax_builder(th)), jac, jnp.float64).initialize(x)

    leaves = jax_leaves(jax.jit(jax.vmap(init))(jnp.asarray(x0), jtheta))
    flat, rebuild = flatten(theta)
    tleaves = tuple(torch.as_tensor(np.asarray(a)) for a in flat)
    tleaves = tuple(t.to(F64) if t.is_floating_point() else t for t in tleaves)
    for i, t in enumerate(tleaves):
        leaves[f"theta.{i}"] = t.numpy()
    solver = mt.Solver(parametric_mop(torch_builder, tleaves, rebuild, True),
                       mt.AlgorithmConfig(**kw), F64, "cpu")
    state, _ = solver.solve_from_state(state_from_numpy(leaves, device="cpu"))
    ref = jax_parametric(jax_builder, jnp.asarray(x0), jtheta, jac, dtype=jnp.float64)
    return state, ref


def assert_matches_jax(state, ref, tol=1e-10):
    """Integers equal on every lane, x and fx within ``tol``."""
    ours = dict(stop_code=state.stop_code, n_iterations=state.iter_counter - 1,
                n_evals=sum(g.n_evals for g in state.groups), x=state.x, fx=state.fx)
    for k in INTS:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(getattr(ref, k)), err_msg=k)
    for k in ("x", "fx"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(getattr(ref, k)), rtol=0,
                                   atol=tol, err_msg=k)


def test_parametric_batch_solves_distinct_problems():
    """JAX's first test: four centres 0.5 .. 2, the same start, max_iter=12.
    From JAX's initial state the port equals JAX lane by lane; the port's
    free run puts each lane within 0.3 of its own Pareto segment."""
    B = 4
    thetas = np.stack([np.full((2,), 0.5 + 0.5 * i) for i in range(B)])
    x0 = np.tile([0.3, -0.2], (B, 1))
    assert_matches_jax(*run_from_jax_initial(jax_build_shifted, build_shifted, x0, thetas,
                                             dict(max_iter=12)))
    res = parametric_multistart(build_shifted, x0, thetas, mt.AlgorithmConfig(max_iter=12),
                                dtype=F64, device="cpu")
    assert res.x.shape == (B, 2)
    for i in range(B):
        th, x = thetas[i], res.x[i].numpy()
        s = x @ th / (2 * th[0] ** 2)
        assert np.linalg.norm(x - np.clip(s, -1, 1) * th) < 0.3, i
    # the lanes' theta is a leaf of the state, in the solve dtype
    (leaf,) = res.state.theta
    assert leaf.dtype == F64 and torch.equal(leaf, torch.as_tensor(thetas))


def test_parametric_lane_matches_individual_solve():
    """JAX's second test: one lane (theta = (1, 1), max_iter=8) equals the
    port's ``optimize`` of that instance (1e-12, equal evaluations), and
    from JAX's initial state JAX's parametric run."""
    theta, x0 = np.array([1.0, 1.0]), np.array([0.3, -0.2])
    ac = mt.AlgorithmConfig(max_iter=8)
    res_b = parametric_multistart(build_shifted, x0[None], theta[None], ac, dtype=F64,
                                  device="cpu")
    res_1 = mt.optimize(build_shifted(torch.as_tensor(theta)), x0, ac, dtype=F64,
                        device="cpu")
    np.testing.assert_allclose(res_b.x[0].numpy(), res_1.x.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(res_b.fx[0].numpy(), res_1.fx.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert int(res_b.n_evals[0]) == int(res_1.n_evals)
    assert_matches_jax(*run_from_jax_initial(jax_build_shifted, build_shifted, x0[None],
                                             theta[None], dict(max_iter=8)))


def _branch_builder(theta):
    """f1 = |x - c|^2, or twice that where the integer leaf k is 1 (a branch
    selected per lane by torch.where); f2 = |x + c|^2."""
    c, k = theta["c"], theta["k"]
    mop = mt.MOP([-4.0, -4.0], [4.0, 4.0])
    mop.add_exact_objective(
        lambda x: torch.where(k == 1, 2.0, 1.0) * torch.sum((x - c) ** 2)[None])
    mop.add_exact_objective(lambda x: torch.sum((x + c) ** 2)[None])
    return mop


def test_integer_leaf_keeps_its_dtype_and_selects_a_branch():
    """An int32 leaf of theta keeps its dtype (float leaves follow the solve
    dtype) and selects each lane's branch: every lane equals ``optimize`` of
    its own instance; the two branches give different runs."""
    B = 4
    theta = {"c": np.tile([1.0, 0.5], (B, 1)).astype(np.float32),
             "k": np.array([0, 1, 0, 1], np.int32)}
    x0 = np.array([[0.3, -0.2], [0.3, -0.2], [-2.0, 1.0], [-2.0, 1.0]])
    ac = mt.AlgorithmConfig(max_iter=10, qp_iters=100)
    res = parametric_multistart(_branch_builder, x0, theta, ac, dtype=F64, device="cpu")
    c, k = res.state.theta
    assert c.dtype == F64 and k.dtype == torch.int32
    for i in range(B):
        one = mt.optimize(_branch_builder({"c": torch.as_tensor(theta["c"][i], dtype=F64),
                                           "k": torch.as_tensor(theta["k"][i])}),
                          x0[i], ac, dtype=F64, device="cpu")
        np.testing.assert_allclose(res.x[i].numpy(), one.x.numpy(), rtol=1e-12, atol=1e-12)
        assert int(res.n_evals[i]) == int(one.n_evals)
        assert int(res.stop_code[i]) == int(one.stop_code)
    assert not torch.allclose(res.fx[0], res.fx[1])


@pytest.mark.parametrize("field", ["ub", "A_ineq", "configs"])
def test_static_structure_depending_on_theta_raises(field):
    """A builder whose upper bound, linear rows or model config depends on
    theta: the builds of the first and the last lane differ, and the error
    names the field."""
    def build(theta):
        t = float(theta[0])
        mop = mt.MOP([-4.0, -4.0], [4.0 + (t if field == "ub" else 0.0), 4.0])
        mop.add_exact_objective(lambda x: torch.sum((x - theta) ** 2)[None])
        # another model for the last lane only
        cfg = RbfConfig() if field == "configs" and t > 1 else ExactConfig()
        mop.add_objective(lambda x: torch.sum((x + theta) ** 2)[None], model_cfg=cfg)
        if field == "A_ineq":
            mop.add_ineq_constraint([[1.0, t]], [1.0])
        return mop

    thetas = np.array([[0.5, 0.5], [2.0, 2.0]])
    with pytest.raises(ValueError, match=field):
        parametric_multistart(build, np.zeros((2, 2)), thetas, mt.AlgorithmConfig(max_iter=2),
                              dtype=F64, device="cpu")


def test_host_function_raises():
    """A host (NumPy) function under parametric_multistart raises a clear
    error, as JAX's pure_callback defines nothing for a closure over the
    traced theta."""
    def build(theta):
        mop = mt.MOP([-4.0, -4.0], [4.0, 4.0])
        mop.add_exact_objective(lambda x: np.sum(x ** 2, keepdims=True), host=True)
        mop.add_exact_objective(lambda x: torch.sum((x + theta) ** 2)[None])
        return mop

    with pytest.raises(ValueError, match="host"):
        parametric_multistart(build, np.zeros((2, 2)), np.ones((2, 2)),
                              mt.AlgorithmConfig(max_iter=2), dtype=F64, device="cpu")


def test_theta_crosses_carry_and_resumes():
    """A parametric state after three trips crosses ``utils/carry`` with its
    theta leaves (dtype kept) and, resumed by the same solver, ends where
    the uninterrupted run ends."""
    B = 4
    thetas = np.stack([np.full((2,), 0.5 + 0.5 * i) for i in range(B)])
    x0 = np.tile([0.3, -0.2], (B, 1))
    ac = mt.AlgorithmConfig(max_iter=8, qp_iters=100)
    full = parametric_multistart(build_shifted, x0, thetas, ac, dtype=F64, device="cpu")
    theta = (torch.as_tensor(thetas),)
    solver = mt.Solver(parametric_mop(build_shifted, theta, flatten(thetas)[1], True), ac,
                       F64, "cpu")
    st = solver.initialize(torch.as_tensor(x0), theta=theta)
    for _ in range(3):
        st = solver.iterate(st)
    leaves = state_to_numpy(st)
    assert leaves["theta.0"].dtype == np.float64
    st, _ = solver.solve_from_state(state_from_numpy(leaves, device="cpu"))
    np.testing.assert_array_equal(st.x.numpy(), full.x.numpy())
    np.testing.assert_array_equal(st.stop_code.numpy(), full.stop_code.numpy())
