"""``RbfConfig(use_max_points=True)`` in the port against the JAX package.

With ``use_max_points`` round 4 also tries ``10 * max_points`` random in-box
candidates after the database rows, drawn with ``jax.random`` from a key
the solver folds per pass. The port draws the same bits with integer torch
ops (``morbit_tpu_torch/ops/prng.py``). At float64 on the CPU:

* ``prng.prng_key``/``fold_in``/``split``/``uniform`` bitwise equal to
  ``jax.random`` for several seeds, shapes and both float widths;
* each lane's initial key equal to JAX's (``sum |x_s 1e6|`` in the
  solver's dtype, then XLA's conversion) at n=2 and n=10;
* the solve without a database (capacity 56 <= 60, so every round 4 scans
  the random candidates) trip by trip from JAX's states, and freely through
  ``optimize``: integers exact, floats within 1e-10;
* at the default capacity the scan ends inside the database rows
  (ROADMAP 3.12): the option changes nothing, in both packages;
* ``tests/test_capacity.py::test_capacity_never_exhausted``'s
  ``use_max_points`` case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.core.algorithm as jalg
import morbit_tpu.problems.synthetic as jsyn
import morbit_tpu_torch as mt
import morbit_tpu_torch.problems.synthetic as tsyn
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu.core.mop import compile_mop as jax_compile_mop
from morbit_tpu.models.configs import RbfConfig as JaxRbf
from morbit_tpu_torch.core.algorithm import Solver
from morbit_tpu_torch.core.mop import compile_mop
from morbit_tpu_torch.models.configs import RbfConfig
from morbit_tpu_torch.ops import prepare_fused, prng
from morbit_tpu_torch.utils.carry import config_from_dict
from tests.test_torch_constraints import jax_state_leaves
from tests.test_torch_scaling_db import _assert_leaves_equal, _lockstep

F64 = torch.float64
LB, UB = np.full(2, -4.0), np.full(2, 4.0)
MQ = dict(kernel="multiquadric", use_max_points=True)


@pytest.mark.parametrize("seed", [0, 1234, 2 ** 32 + 77])
def test_prng_matches_jax_random(seed):
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    for data in (0, 3, 7001, 2 ** 31 + 5, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(key, data).numpy(),
                                      np.asarray(jax.random.fold_in(jkey, data)))
    np.testing.assert_array_equal(prng.split(key, 5).numpy(),
                                  np.asarray(jax.random.split(jkey, 5)))
    # a lane axis of keys: each lane draws from its own key
    keys = prng.fold_in(key, torch.arange(4))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        for shape in ((60, 2), (7,), (3, 5, 2)):
            got = prng.uniform(keys, shape, dt)
            for b in range(4):
                want = jax.random.uniform(jax.random.fold_in(jkey, b), shape, dtype=jdt)
                np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [2, 10])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_initial_key_matches_jax(n, dtype):
    """The per-lane seed ``fold_in(PRNGKey(1234), uint32(sum |x_s 1e6|))``
    as the JAX package's vmapped, jitted ``initialize`` computes it; sites
    in the unit cube, a few outside it and one whose sum passes 2^32."""
    rng = np.random.default_rng(n)
    x_s = rng.uniform(0.0, 1.0, (64, n)).astype(dtype)
    x_s[:4] *= rng.uniform(1.0, 50.0, (4, 1)).astype(dtype)
    x_s[4] = 5e3
    ref = jax.jit(jax.vmap(lambda v: jax.random.fold_in(
        jax.random.PRNGKey(1234), jnp.sum(jnp.abs(v * 1e6)).astype(jnp.uint32))))(
        jnp.asarray(x_s))
    got = Solver._initial_key(torch.as_tensor(x_s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _mop(port, **cfg):
    if port:
        return tsyn.make_two_parabolas(RbfConfig(**cfg), LB, UB)
    return jsyn.make_two_parabolas(JaxRbf(**cfg), LB, UB)


def test_lockstep_without_database_matches_jax():
    """No database (capacity 56 <= 60): every round 4 scans the 56 rows
    and 60 random candidates. Trip by trip from JAX's states (the key
    carried), each port trip equals JAX's next state, every leaf within
    1e-10, integers exact; the initial states agree too, the key included."""
    kw = dict(max_iter=12, use_db=False)
    x0s = np.array([[-3.0, 2.5], [1.5, -3.2]])
    jsolver = jalg.Solver(jax_compile_mop(_mop(False, **MQ)), JaxConfig(**kw), jnp.float64)
    solver = Solver(compile_mop(_mop(True, **MQ)),
                    config_from_dict(dataclasses.asdict(JaxConfig(**kw))), F64, "cpu")
    assert solver.db_capacity == 56 and solver.container.ops[0].n_rand == 60
    leaves = lambda st: {**jax_state_leaves(st), "key": np.asarray(st.key)}
    compare = lambda a, b: _assert_leaves_equal(a, b, 1e-10, 2 + 2 + 1)
    init = jax.jit(jax.vmap(jsolver.initialize))(jnp.asarray(x0s))
    from morbit_tpu_torch.utils.carry import state_to_numpy
    compare(state_to_numpy(solver.initialize(x0s)), leaves(init))
    calls = []
    real = prepare_fused.round4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prepare_fused, "round4",
                   lambda X, *a, **k: calls.append(X.shape[1]) or real(X, *a, **k))
        _, trips = _lockstep(jsolver, solver, init, compare, leaves)
    assert trips > 5 and set(calls) == {116}


def test_optimize_without_database_matches_jax():
    """``optimize(use_db=False)`` with ``use_max_points`` from (-3, 2.5):
    the run the JAX package makes with 73 evaluations (49 without the
    option), integers exact and iterates within 1e-10."""
    x0 = [-3.0, 2.5]
    ref = jalg.optimize(_mop(False, **MQ), jnp.asarray(x0), max_iter=20, use_db=False,
                        dtype=jnp.float64)
    res = mt.optimize(_mop(True, **MQ), x0, max_iter=20, use_db=False, device="cpu")
    assert int(res.n_evals) == int(ref.n_evals) == 73
    for f in ("stop_code", "n_iterations"):
        assert int(getattr(res, f)) == int(getattr(ref, f)), f
    np.testing.assert_array_equal(res.state.key.numpy(), np.asarray(ref.state.key))
    k = int(ref.state.traj.count)
    np.testing.assert_array_equal(res.state.traj.it_stat[:k].numpy(),
                                  np.asarray(ref.state.traj.it_stat)[:k])
    np.testing.assert_allclose(res.state.traj.x[:k].numpy(), np.asarray(ref.state.traj.x)[:k],
                               rtol=0, atol=1e-10)
    plain = mt.optimize(_mop(True, kernel="multiquadric"), x0, max_iter=20, use_db=False,
                        device="cpu")
    assert int(plain.n_evals) == 49


def test_default_capacity_scans_no_random_candidate():
    """ROADMAP 3.12: at the default capacity (307 rows > 10 max_points)
    the round-4 scan of ``min(cap, 60) + 60`` rows ends inside the database,
    so ``use_max_points`` changes nothing, in both packages; the port's K3
    calls scan 120 database rows."""
    x0 = [-3.0, 2.5]
    runs = {}
    for ump in (False, True):
        cfg = dict(kernel="multiquadric", use_max_points=ump)
        runs[("jax", ump)] = jalg.optimize(_mop(False, **cfg), jnp.asarray(x0), max_iter=20,
                                           dtype=jnp.float64)
        calls = []
        real = prepare_fused.round4
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(prepare_fused, "round4",
                       lambda X, *a, **k: calls.append(X.shape[1]) or real(X, *a, **k))
            runs[("port", ump)] = mt.optimize(_mop(True, **cfg), x0, max_iter=20,
                                              device="cpu")
        assert set(calls) == {60 + 60 * ump}
    for pkg in ("jax", "port"):
        a, b = runs[(pkg, False)], runs[(pkg, True)]
        assert int(a.n_evals) == int(b.n_evals) == 17
        np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
    np.testing.assert_allclose(runs[("port", True)].x.numpy(), np.asarray(runs[("jax", True)].x),
                               rtol=0, atol=1e-10)


def test_staged_capacities_scan_random_candidates():
    """ROADMAP 3.12 in the staged runner: a stage capacity below 60 rows
    scans its rows and the 60 random candidates (C = cap + 60 < 120), the
    full capacity only the first 120 database rows, so a staged run with a
    database may part from the plain run (the JAX package's runners behave
    alike)."""
    x0 = tsyn.halton_starts(4, LB, UB)
    ac = mt.AlgorithmConfig(max_iter=16)
    seen = {"plain": set(), "staged": set()}
    real = prepare_fused.round4
    runs = (("plain", lambda m: mt.multistart_optimize(m, x0, ac, F64, "cpu")),
            ("staged", lambda m: mt.StagedMultistart(m, ac, F64, device="cpu")(x0)))
    for name, run in runs:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(prepare_fused, "round4",
                       lambda X, *a, name=name, **k: seen[name].add(X.shape[1])
                       or real(X, *a, **k))
            res = run(_mop(True, **MQ))
        assert torch.isfinite(res.x).all()
    assert seen["plain"] == {120}
    assert min(seen["staged"]) < 120


def test_capacity_never_exhausted_with_use_max_points():
    """``tests/test_capacity.py::test_capacity_never_exhausted``'s
    ``RbfConfig(kernel='cubic', use_max_points=True)`` case: the fill stays
    below the capacity and every valid row is evaluated."""
    res = mt.optimize(_mop(True, kernel="cubic", use_max_points=True), [-3.0, 2.5],
                      max_iter=12, device="cpu")
    for st in res.state.groups:
        count = int(st.db.count)
        assert count < st.db.data.shape[-2]
        assert bool(st.db.evaluated[:count].all())
