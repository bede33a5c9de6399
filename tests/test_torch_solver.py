"""The port's trust-region solver against the oracle and the JAX package.

* ``optimize`` at float64 on the CPU against the sequential NumPy/SciPy
  oracle (``tests/oracle_sequential.py``) on the five unconstrained configs
  of ``tests/test_oracle_parity.py``: integer observables exact, floats
  within that file's per-config tolerances;
* ``multistart_optimize`` with 8 Halton starts against JAX's batched
  ``multistart_optimize`` lane by lane, and against the port's own B=1 runs;
* one ``iterate`` per outer trip from JAX states carried across with
  ``state_from_numpy``, against JAX's ``iterate``: the first trip whose
  state differs is the one that fails.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.core.algorithm as jalg
import morbit_tpu.parallel.multistart as jms
import morbit_tpu.problems.synthetic as jsyn
import morbit_tpu_torch as mt
import morbit_tpu_torch.problems.synthetic as tsyn
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu.core.mop import compile_mop as jax_compile_mop
from morbit_tpu_torch.core.algorithm import Solver
from morbit_tpu_torch.core.mop import compile_mop
from morbit_tpu_torch.utils.carry import (config_from_dict, state_from_numpy,
                                          state_to_numpy)
from morbit_tpu_torch.utils.logging import trajectory_arrays
from morbit_tpu_torch.utils.tree import tree_map
from tests.oracle_sequential import solve_oracle

LB2, UB2 = [-4.0, -4.0], [4.0, 4.0]


def _two_parabolas():
    mop = mt.MOP(LB2, UB2)
    mop.add_exact_objective(lambda x: torch.sum((x - 1.0) ** 2))
    mop.add_exact_objective(lambda x: torch.sum((x + 1.0) ** 2))
    F = lambda x: np.array([np.sum((x - 1.0) ** 2), np.sum((x + 1.0) ** 2)])
    J = lambda x: np.stack([2.0 * (x - 1.0), 2.0 * (x + 1.0)])
    return mop, F, J, np.full(2, -4.0), np.full(2, 4.0), np.array([-3.0, 2.5])


def _three_var():
    mop = mt.MOP([-2.0] * 3, [3.0] * 3)
    mop.add_exact_objective(
        lambda x: (x[0] - 1.0) ** 2 + 2.0 * x[1] ** 2 + 0.5 * x[2] ** 2)
    mop.add_exact_objective(
        lambda x: (x[0] + 1.0) ** 2 + (x[1] - 0.5) ** 2 + x[2] ** 2
        + 0.1 * x[0] * x[1])
    F = lambda x: np.array([
        (x[0] - 1.0) ** 2 + 2.0 * x[1] ** 2 + 0.5 * x[2] ** 2,
        (x[0] + 1.0) ** 2 + (x[1] - 0.5) ** 2 + x[2] ** 2 + 0.1 * x[0] * x[1]])
    J = lambda x: np.array([
        [2.0 * (x[0] - 1.0), 4.0 * x[1], 1.0 * x[2]],
        [2.0 * (x[0] + 1.0) + 0.1 * x[1],
         2.0 * (x[1] - 0.5) + 0.1 * x[0], 2.0 * x[2]]])
    return (mop, F, J, np.full(3, -2.0), np.full(3, 3.0),
            np.array([2.0, -1.5, 2.5]))


# the unconstrained configs of tests/test_oracle_parity.py, same tolerances
CASES = {
    "2var-default": (_two_parabolas, dict(max_iter=10), 1e-12),
    "2var-budget": (_two_parabolas, dict(max_iter=40, max_evals=25), 1e-12),
    "2var-critical": (_two_parabolas,
                      dict(max_iter=40, f_tol_rel=0.0, x_tol_rel=0.0), 1e-11),
    "3var-default": (_three_var, dict(max_iter=12), 1e-12),
    "3var-critical": (_three_var,
                      dict(max_iter=60, f_tol_rel=0.0, x_tol_rel=0.0), 1e-3),
}


@pytest.mark.parametrize("label", CASES)
def test_optimize_matches_oracle(label):
    make, kw, tol = CASES[label]
    mop, F, J, lb, ub, x0 = make()
    res = mt.optimize(mop, x0, device="cpu", dtype=torch.float64, **kw)
    tr = trajectory_arrays(res)
    orc = solve_oracle(F, J, lb, ub, x0, **kw)

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


def _assert_lane_equal(port, ref, lane, ref_lane=None, tol=1e-10):
    """Integers exact, floats within ``tol``: port lane vs reference lane."""
    r = lane if ref_lane is None else ref_lane
    tp, tr_ = trajectory_arrays(port, lane), ref(r)
    assert int(port.stop_code[lane]) == tr_["stop_code"]
    assert int(port.n_iterations[lane]) == tr_["n_iterations"]
    assert [int(g.n_evals[lane]) for g in port.state.groups] == tr_["n_evals"]
    assert tp["it_stat"].tolist() == tr_["it_stat"].tolist()
    np.testing.assert_array_equal(tp["x_indices"], tr_["x_indices"])
    for name in ("x", "fx"):
        np.testing.assert_allclose(tp[name], tr_[name], rtol=0, atol=tol)
    np.testing.assert_allclose(port.x[lane].numpy(), tr_["x_final"], rtol=0, atol=tol)


def test_multistart_matches_jax_and_single_runs():
    B, kw = 8, dict(max_iter=10)
    starts = tsyn.halton_starts(B, LB2, UB2)
    port = mt.multistart_optimize(tsyn.make_two_parabolas(lb=LB2, ub=UB2),
                                  starts, mt.AlgorithmConfig(**kw),
                                  dtype=torch.float64, device="cpu")
    ref = jms.multistart_optimize(jsyn.make_two_parabolas(lb=LB2, ub=UB2),
                                  jnp.asarray(starts), JaxConfig(**kw),
                                  dtype=jnp.float64)

    def jax_lane(i):
        traj = ref.state.traj
        c = int(traj.count[i])
        return dict(stop_code=int(ref.stop_code[i]),
                    n_iterations=int(ref.n_iterations[i]),
                    n_evals=[int(g.n_evals[i]) for g in ref.state.groups],
                    it_stat=np.asarray(traj.it_stat[i][:c]),
                    x_indices=np.asarray(traj.x_indices[i][:c]),
                    x=np.asarray(traj.x[i][:c]), fx=np.asarray(traj.fx[i][:c]),
                    x_final=np.asarray(ref.x[i]))

    for i in range(B):
        _assert_lane_equal(port, jax_lane, i)
        single = mt.multistart_optimize(
            tsyn.make_two_parabolas(lb=LB2, ub=UB2), starts[i:i + 1],
            mt.AlgorithmConfig(**kw), dtype=torch.float64, device="cpu")

        def single_lane(_):
            tr = trajectory_arrays(single, 0)
            return dict(stop_code=int(single.stop_code[0]),
                        n_iterations=int(single.n_iterations[0]),
                        n_evals=[int(g.n_evals[0]) for g in single.state.groups],
                        x_final=single.x[0].numpy(), **tr)

        _assert_lane_equal(port, single_lane, i, 0, tol=1e-12)
    # one batched solve: as many trips as its longest lane needs (one more
    # for a lane that stops at the max_iter test)
    assert port.trips >= int(port.n_iterations.max())


def _jax_leaves(st):
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
    return out


# float tolerance per config: near a critical point the stamped rho is a
# ratio of differences of nearly equal values, which amplifies the last-bit
# difference between XLA's and torch's evaluation of f (measured up to
# 7.3e-5 there, and < 1e-12 elsewhere); integer leaves are exact in both
CARRY_CASES = {
    "2var-default": (dict(max_iter=10), 1e-10, 5),
    "2var-critical": (dict(max_iter=40, f_tol_rel=0.0, x_tol_rel=0.0), 1e-4, 4),
}


@pytest.mark.parametrize("label", CARRY_CASES)
def test_iterate_from_carried_jax_state(label):
    """Every outer trip of a run: the port's ``iterate`` from the carried
    JAX state equals JAX's next state, leaf by leaf."""
    kw, tol, final_stop = CARRY_CASES[label]
    jac = JaxConfig(**kw)
    jsolver = jalg.Solver(jax_compile_mop(jsyn.make_two_parabolas(
        lb=LB2, ub=UB2)), jac, jnp.float64)
    jiter = jax.jit(jsolver.iterate)
    ac = config_from_dict(dataclasses.asdict(jac))
    solver = Solver(compile_mop(tsyn.make_two_parabolas(lb=LB2, ub=UB2)), ac,
                    torch.float64, "cpu")

    st = jax.jit(jsolver.initialize)(jnp.asarray([-3.0, 2.5]))
    modes = set()
    for trip in range(200):
        if int(st.stop_code) != 1:
            break
        nxt = jiter(st)
        port = state_to_numpy(solver.iterate(state_from_numpy(_jax_leaves(st),
                                                              device="cpu")))
        ref = _jax_leaves(nxt)
        assert set(port) == set(ref)
        for name, a in port.items():
            b = ref[name][None]
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=f"trip {trip}: {name}")
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                           err_msg=f"trip {trip}: {name}")
        modes.add(int(nxt.crit_mode))
        st = nxt
    assert int(st.stop_code) == final_stop
    if final_stop == 4:                  # CRITICAL, through micro-steps
        assert {1, 2} & modes


def test_iterate_refuses_a_state_on_another_device():
    """The kernels' wrappers route by the device of their tensors, so a
    state that does not lie on the solver's device must not reach them:
    ``iterate`` raises (a CPU solver here, its state moved to the meta
    device)."""
    solver = Solver(compile_mop(_two_parabolas()[0]), mt.AlgorithmConfig(max_iter=3),
                    torch.float64, "cpu")
    state = solver.initialize(torch.zeros((2, 2), dtype=torch.float64))
    solver.iterate(state)
    with pytest.raises(ValueError, match="lies on meta"):
        solver.iterate(tree_map(lambda t: t.to("meta"), state))


def test_carried_state_defaults_to_cuda():
    """``state_from_numpy`` puts a carried state on the solvers' default
    device, CUDA, and raises without it; ``device="cpu"`` asks for the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is usable")
    solver = Solver(compile_mop(_two_parabolas()[0]), mt.AlgorithmConfig(max_iter=3),
                    torch.float64, "cpu")
    leaves = state_to_numpy(solver.initialize(torch.zeros((2, 2), dtype=torch.float64)))
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy(leaves)
    again = state_to_numpy(state_from_numpy(leaves, device="cpu"))
    assert all(np.array_equal(again[k], v) for k, v in leaves.items())
