"""The port's ``parametric_multistart`` with θ inside a nonlinear
inequality constraint modelled by an RBF group, against the JAX package's,
at float64 on the CPU: from JAX's initial state, integers equal on every
lane (stop code, iterations, evaluations), x and fx within 1e-10
(``tests/test_torch_parametric.py`` for the unconstrained locks).
"""

import jax.numpy as jnp
import numpy as np
import torch

import morbit_tpu_torch as mt
from morbit_tpu.core.mop import MOP as JaxMOP
from morbit_tpu.models.configs import ExactConfig as JaxExact
from morbit_tpu.models.configs import RbfConfig as JaxRbf
from morbit_tpu_torch.models.configs import RbfConfig
from morbit_tpu_torch.parallel.multistart import parametric_multistart
from test_torch_parametric import assert_matches_jax, run_from_jax_initial


def build_ball(theta):
    """The two parabolas (exact objectives) centred at +-theta["c"] inside
    the ball ||x||^2 <= theta["r"]^2, the constraint in one cubic RBF
    group."""
    mop = mt.MOP([-4.0, -4.0], [4.0, 4.0])
    c, r = theta["c"], theta["r"]
    mop.add_exact_objective(lambda x: torch.sum((x - c) ** 2)[None])
    mop.add_exact_objective(lambda x: torch.sum((x + c) ** 2)[None])
    mop.add_nl_ineq_constraint(lambda x: (torch.sum(x ** 2) - r ** 2)[None],
                               model_cfg=RbfConfig(kernel="cubic"))
    return mop


def jax_build_ball(theta):
    mop = JaxMOP([-4.0, -4.0], [4.0, 4.0])
    c, r = theta["c"], theta["r"]
    mop.add_objective(lambda x: jnp.sum((x - c) ** 2)[None], model_cfg=JaxExact())
    mop.add_objective(lambda x: jnp.sum((x + c) ** 2)[None], model_cfg=JaxExact())
    mop.add_nl_ineq_constraint(lambda x: (jnp.sum(x ** 2) - r ** 2)[None],
                               model_cfg=JaxRbf(kernel="cubic"))
    return mop


def test_parametric_constraint_matches_jax():
    """Radii 1, 1.5, 2, 2.5 with the centres +-(1.5, 1), from starts
    outside some of the balls (restoration and the normal step run):
    integers equal to JAX's on every lane, x and fx within 1e-10; the
    port's free run ends feasible on every lane."""
    B = 4
    theta = {"c": np.tile([1.5, 1.0], (B, 1)), "r": np.array([1.0, 1.5, 2.0, 2.5])}
    x0 = np.array([[2.0, 1.5], [-1.0, 2.5], [0.5, -0.5], [3.0, -3.0]])
    kw = dict(max_iter=10, qp_iters=200)
    state, ref = run_from_jax_initial(jax_build_ball, build_ball, x0, theta, kw)
    assert_matches_jax(state, ref)
    # the leaves in JAX's order (sorted keys)
    assert [tuple(t.shape) for t in state.theta] == [(B, 2), (B,)]
    res = parametric_multistart(build_ball, x0, theta, mt.AlgorithmConfig(**kw),
                                dtype=torch.float64, device="cpu")
    assert (res.state.c_i[:, 0] <= 1e-6).all()
