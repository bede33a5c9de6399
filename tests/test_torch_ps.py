"""The port's Pascoletti-Serafini descent against the JAX package and the
oracles.

At float64 on the CPU:

* ``ps_subsolver_budgets`` over the table of
  ``tests/test_config_options.py::test_ps_subsolver_budgets_resolution``;
* ``maximize_in_box`` (``ops/boxopt.py``) against JAX's, on a sweep whose
  values all tie and on a smooth function with polish;
* ``optimize`` on the oracle configs ``ps-refdir`` and ``ps-ideal-point``
  (at 1e-12) and on the PS golden trajectory;
* the subsolver eval charges of ``tests/test_ps_eval_counting.py``: exact
  groups charged their budgets, model groups not, and a budget that the
  charges exhaust halts the run, each against JAX's counts;
* a B=4 batch against the port's four single runs and the staged runner
  against the plain one.
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
import morbit_tpu.ops.boxopt as jbox
import morbit_tpu_torch as mt
import morbit_tpu_torch.core.descent as tdesc
import morbit_tpu_torch.ops.boxopt as tbox
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu.core.mop import compile_mop as jax_compile_mop
from morbit_tpu.models.configs import ExactConfig as JaxExact
from morbit_tpu.models.configs import RbfConfig as JaxRbf
from morbit_tpu.utils.parity import compare_trajectories
from morbit_tpu_torch.core.algorithm import Solver
from morbit_tpu_torch.core.descent import PascolettiSerafiniConfig
from morbit_tpu_torch.core.enums import STOP_CODE
from morbit_tpu_torch.core.mop import compile_mop
from morbit_tpu_torch.models.configs import ExactConfig, RbfConfig
from morbit_tpu_torch.utils.parity import export_trajectory
from tests.torch_families import (F64, GOLDEN_X0, X0, assert_batch_equals_singles_and_staged,
                                  assert_matches_oracle, oracle_groups, parabolas)

#: the budget table of test_ps_subsolver_budgets_resolution, (config, n)
BUDGET_CASES = [
    (dict(), 2), (dict(), 5), (dict(max_ps_problem_evals=100), 2),
    (dict(max_ps_problem_evals=100, ps_polish=True), 2),
    (dict(max_ps_problem_evals=100, max_ps_polish_evals=10), 2),
    (dict(n_samples=64, polish_iters=20), 2),
    (dict(max_ideal_point_problem_evals=40, n_samples=64, polish_iters=20), 2),
]


@pytest.mark.parametrize("kw,n", BUDGET_CASES)
def test_subsolver_budgets_match_jax(kw, n):
    port = tdesc.ps_subsolver_budgets(PascolettiSerafiniConfig(**kw), n)
    assert port == jdesc.ps_subsolver_budgets(jdesc.PascolettiSerafiniConfig(**kw), n)
    assert tdesc.resolve_descent_config("ps") == PascolettiSerafiniConfig()
    assert tdesc.resolve_descent_config("pascoletti_serafini") == PascolettiSerafiniConfig()


def test_maximize_in_box_ties_pick_jax_starts():
    """A sweep whose values all tie (|l_0| = 1 everywhere for B = eye): the
    refined starts, and so the result, are JAX's, the lowest indices
    first (``jax.lax.top_k``)."""
    grid = tbox.halton_grid(50, 2)
    lb, ub = torch.zeros((3, 2), dtype=F64), torch.ones((3, 2), dtype=F64)
    const = lambda X: torch.ones(X.shape[:-1], dtype=F64)
    extra = torch.full((3, 1, 2), 0.3, dtype=F64)
    x, v = tbox.maximize_in_box(const, lb, ub, grid, iters=3, extra_starts=extra,
                                n_starts=8, grad=lambda X: torch.zeros_like(X))
    jx, jv = jbox.maximize_in_box(lambda u: jnp.asarray(1.0), jnp.zeros(2), jnp.ones(2),
                                  grid, iters=3, extra_starts=jnp.full((1, 2), 0.3),
                                  n_starts=8)
    np.testing.assert_array_equal(x.numpy(), np.broadcast_to(np.asarray(jx), (3, 2)))
    F, idx = tbox.top_k(torch.ones((2, 51), dtype=F64), 8)
    assert idx.tolist() == [list(range(8))] * 2


def test_maximize_in_box_polish_matches_jax():
    """Sweep and projected gradient polish of a smooth function, per lane
    boxes, autograd against ``jax.grad``."""
    rng = np.random.default_rng(3)
    c = rng.uniform(-1, 1, (4, 2))
    lb = rng.uniform(-1, 0, (4, 2))
    ub = lb + rng.uniform(0.5, 2, (4, 2))
    grid = tbox.halton_grid(40, 2)
    ct = torch.as_tensor(c)
    f = lambda X: -((X - ct[:, None, :]) ** 2).sum(-1) + 0.3 * torch.sin(3 * X[..., 0])
    x, v = tbox.minimize_in_box(lambda X: -f(X), torch.as_tensor(lb), torch.as_tensor(ub),
                                grid, iters=12, n_starts=3)
    for i in range(4):
        fj = lambda u, i=i: -jnp.sum((u - c[i]) ** 2) + 0.3 * jnp.sin(3 * u[0])
        jx, jv = jbox.minimize_in_box(lambda u: -fj(u), jnp.asarray(lb[i]), jnp.asarray(ub[i]),
                                      grid, iters=12, n_starts=3)
        np.testing.assert_allclose(x[i].numpy(), np.asarray(jx), rtol=0, atol=1e-12)
        np.testing.assert_allclose(float(v[i]), float(jv), rtol=0, atol=1e-12)


@pytest.mark.parametrize("label", ["ps-refdir", "ps-ideal-point"])
def test_optimize_matches_full_oracle(label):
    """The oracle configs of tests/test_oracle_full_parity.py: exact
    objectives, reference-default budgets (a 1500-point sweep, no polish),
    with a reference direction or the local ideal point."""
    if label == "ps-refdir":
        desc, okw, it = PascolettiSerafiniConfig(reference_direction=(1.0, 1.0)), dict(
            descent="ps", ps_reference_direction=(1.0, 1.0)), 4
    else:
        desc, okw, it = PascolettiSerafiniConfig(), dict(descent="ps"), 3
    assert_matches_oracle(None, oracle_groups(exact=True), 1e-12, okw=okw, exact=True,
                          max_iter=it, descent_method=desc)


def test_trajectory_matches_ps_golden():
    res = mt.optimize(parabolas(RbfConfig(kernel="multiquadric")), GOLDEN_X0, max_iter=15,
                      descent_method="ps", device="cpu", dtype=F64)
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "two_parabolas_rbf_ps_f64.json")) as f:
        golden = json.load(f)
    rep = compare_trajectories(export_trajectory(res), golden, x_tol=1e-10)
    assert rep["parity"], rep


def _charges(ps_kw, exact):
    """Each group's eval count change over one PS criticality solve from the
    initial state, in the port and in JAX."""
    out = []
    for port in (True, False):
        if port:
            s = Solver(compile_mop(parabolas(ExactConfig() if exact else RbfConfig(
                kernel="multiquadric"))), mt.AlgorithmConfig(
                descent_method=PascolettiSerafiniConfig(**ps_kw), max_iter=5), F64, "cpu")
            st = s.initialize(X0)
            g2 = s._ps_criticality(st.groups, st.x_s, st.x_s, st.fx, st.delta, st.scal)[2]
            out.append([int(b.n_evals[0]) - int(a.n_evals[0])
                        for a, b in zip(st.groups, g2)])
        else:
            s = jalg.Solver(jax_compile_mop(parabolas(JaxExact() if exact else JaxRbf(
                kernel="multiquadric"), port=False)), JaxConfig(
                descent_method=jdesc.PascolettiSerafiniConfig(**ps_kw), max_iter=5),
                jnp.float64)
            st = jax.jit(s.initialize)(jnp.asarray(X0))
            g2 = jax.jit(s._ps_criticality)(st.groups, st.x_s, st.x_s, st.fx, st.delta,
                                            st.scal)[2]
            out.append([int(b.n_evals) - int(a.n_evals) for a, b in zip(st.groups, g2)])
    return out


@pytest.mark.parametrize("ps_kw,exact,expected", [
    (dict(n_samples=32, polish_iters=8), True, 40 + 2 * 40),
    (dict(reference_direction=(1.0, 1.0), n_samples=32, polish_iters=8), True, 40),
    (dict(n_samples=32, polish_iters=8), False, 0),
    (dict(), True, 1500 + 2 * 1500),
], ids=["exact", "exact-refdir", "rbf", "reference-defaults"])
def test_eval_charges_match_jax(ps_kw, exact, expected):
    """One PS solve charges exact groups ``ps_grid + ps_polish`` plus, with
    no reference, ``m_obj (ideal_grid + ideal_polish)``; model groups pay
    nothing (``tests/test_ps_eval_counting.py``)."""
    port, ref = _charges(ps_kw, exact)
    assert port == ref == [expected] * len(port)


def test_budget_exhaustion_halts_like_jax():
    ps = dict(n_samples=32, polish_iters=8)
    kw = dict(max_iter=30, max_evals=150)
    res = mt.optimize(parabolas(exact=True), X0, descent_method=PascolettiSerafiniConfig(**ps),
                      device="cpu", dtype=F64, **kw)
    ref = jalg.optimize(parabolas(port=False, exact=True), jnp.asarray(X0),
                        descent_method=jdesc.PascolettiSerafiniConfig(**ps),
                        dtype=jnp.float64, **kw)
    assert int(res.stop_code) == int(ref.stop_code) == int(STOP_CODE.BUDGET_EXHAUSTED)
    assert int(res.n_iterations) == int(ref.n_iterations)
    assert [int(g.n_evals) for g in res.state.groups] == [int(g.n_evals)
                                                          for g in ref.state.groups]
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-10)


@pytest.mark.parametrize("desc", [PascolettiSerafiniConfig(),
                                  PascolettiSerafiniConfig(reference_point=(0.0, 0.0),
                                                           n_samples=64, polish_iters=6)],
                         ids=["ideal-point", "reference-point-polish"])
def test_batch_equals_singles_and_staged(desc):
    res = assert_batch_equals_singles_and_staged(
        RbfConfig(kernel="multiquadric"), mt.AlgorithmConfig(max_iter=6, descent_method=desc))
    assert torch.isfinite(res.x).all()
