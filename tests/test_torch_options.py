"""Control options of the PyTorch port against the JAX package: the
strict filter and the non-strict acceptance test (no oracle locks them),
solver-state checkpoints and the run report.

At float64 on the CPU: both filter variants on the constrained slice, trip
by trip from JAX's states (every leaf within 1e-10, integers exact); a
checkpoint saved mid-run resumes to the uninterrupted run's bits;
``print_report``, ``overflow_warnings`` and ``function_eval_counts`` give
JAX's text and counts on a carried JAX result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.core.algorithm as jalg
import morbit_tpu.utils.logging as jlog
import morbit_tpu_torch as mt
import morbit_tpu_torch.problems.synthetic as tsyn
import morbit_tpu_torch.utils.logging as tlog
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu.core.mop import MOP as JaxMOP
from morbit_tpu.core.mop import compile_mop as jax_compile_mop
from morbit_tpu.models.configs import RbfConfig as JaxRbf
from morbit_tpu_torch.core.algorithm import Solver
from morbit_tpu_torch.core.mop import compile_mop
from morbit_tpu_torch.models.configs import RbfConfig
from morbit_tpu_torch.utils.carry import config_from_dict, state_from_numpy
from morbit_tpu_torch.utils.checkpoint import load_state, save_state, tree_leaves
from tests.test_torch_constraints import _jax_slice_mop, _slice_mop, jax_state_leaves
from tests.test_torch_scaling_db import _assert_leaves_equal, _lockstep

F64 = torch.float64
LB2, UB2 = [-4.0, -4.0], [4.0, 4.0]


# ------------------------------------------------- filter and acceptance

@pytest.mark.parametrize("variant", [dict(filter_type="strict"),
                                     dict(strict_acceptance_test=False)])
def test_filter_variants_match_jax(variant):
    """The strict filter and the non-strict acceptance test (no oracle
    locks them) on the constrained slice at B=8: every trip of JAX's batched
    solve, the port's trip from JAX's state equal to JAX's next state,
    every leaf within 1e-10 (integers exact). Run freely, one lane parts
    from JAX at trip 3 under the non-strict test: the iterates agree to
    1e-12, and a model built from tied box exits (ROADMAP 3.4) decides."""
    kw = dict(max_iter=10, **variant)
    starts = tsyn.halton_starts(8, LB2, UB2, start_index=10)
    jsolver = jalg.Solver(jax_compile_mop(_jax_slice_mop()), JaxConfig(**kw), jnp.float64)
    solver = Solver(compile_mop(_slice_mop()),
                    config_from_dict(dataclasses.asdict(JaxConfig(**kw))), F64, "cpu")
    init = jax.jit(jax.vmap(jsolver.initialize))(jnp.asarray(starts))
    compare = lambda a, b: _assert_leaves_equal(a, b, 1e-10, 2 + 2 + 1)
    st, trips = _lockstep(jsolver, solver, init, compare)
    assert trips >= 10 and int(np.asarray(st.filter.count).max()) > 0
    if "filter_type" in variant:
        assert solver.filter_mode == "strict" and np.asarray(st.filter.fvals).shape[-1] == 2


# ------------------------------------------------- checkpoint and report

def test_checkpoint_round_trip(tmp_path):
    """A state saved after three trips and loaded into a fresh state's
    structure equals it leaf by leaf to the bit, and the resumed solve
    equals the uninterrupted one to the bit."""
    mop = lambda: tsyn.make_two_parabolas(RbfConfig(kernel="multiquadric"), LB2, UB2)
    solver = Solver(compile_mop(mop()), mt.AlgorithmConfig(max_iter=10), F64, "cpu")
    x0 = tsyn.halton_starts(3, LB2, UB2)
    state = solver.initialize(x0)
    for _ in range(3):
        state = solver.iterate(state)
    path = str(tmp_path / "ckpt.npz")
    save_state(path, state)
    restored = load_state(path, solver.initialize(x0))
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    end_a, trips_a = solver.solve_from_state(state)
    end_b, trips_b = solver.solve_from_state(restored)
    assert trips_a == trips_b
    for a, b in zip(tree_leaves(end_a), tree_leaves(end_b)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        load_state(path, solver.initialize(x0).groups)


@pytest.mark.parametrize("overflow", [False, True])
def test_print_report_matches_jax(overflow):
    """``print_report`` at verbosity 2, ``overflow_warnings`` and
    ``function_eval_counts`` on a JAX result carried into the port give
    JAX's text and counts (with a database too small, its warning too)."""
    kw = dict(max_iter=6, **(dict(db_capacity=6) if overflow else {}))
    jmop = JaxMOP(LB2, UB2)
    cfg = JaxRbf(kernel="multiquadric")
    f = lambda x: jnp.sum((x - 1.0) ** 2)
    jmop.add_objective(f, model_cfg=cfg)
    jmop.add_objective(lambda x: jnp.sum((x + 1.0) ** 2), model_cfg=cfg)
    jmop.add_objective(f, model_cfg=cfg)
    ref = jalg.optimize(jmop, jnp.array([-3.0, 2.5]), dtype=jnp.float64, **kw)
    state = state_from_numpy(jax_state_leaves(ref.state), device="cpu")
    port = mt.OptimizeResult(x=state.x, fx=state.fx, stop_code=state.stop_code,
                             n_iterations=state.iter_counter - 1,
                             n_evals=state.groups[0].n_evals, state=state, trips=0)
    lines, jlines = [], []
    tlog.print_report(port, verbosity=2, out=lines.append, lane=0)
    jlog.print_report(ref, verbosity=2, out=jlines.append)
    assert lines == jlines
    assert any("WARNING" in s for s in lines) == overflow
    assert tlog.overflow_warnings(port.state, 0) == jlog.overflow_warnings(ref.state)
    port_mop = mt.MOP(LB2, UB2)
    pf = lambda x: torch.sum((x - 1.0) ** 2)
    for fn in (pf, lambda x: torch.sum((x + 1.0) ** 2), pf):
        port_mop.add_objective(fn, model_cfg=RbfConfig(kernel="multiquadric"))
    assert (tlog.function_eval_counts(port, compile_mop(port_mop), 0)
            == jlog.function_eval_counts(ref, jax_compile_mop(jmop)) == [int(ref.n_evals)] * 3)
