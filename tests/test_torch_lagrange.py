"""The port's Lagrange surrogates against the JAX package and the oracles.

At float64 on the CPU:

* ``monomial_exponents`` and the closed-form ascent gradient of |l(u)|
  (``jax.grad``'s, +1 at a zero of l) against JAX;
* the poised set of one database state at degree 1 and 2 (Algorithms 6.2
  and 6.3 with the grid and ascent maximization): point sources exact
  against the oracle and JAX, new sites within 1e-6;
* ``allow_not_linear``: a batch with a per-lane ensure-fully-linear flag
  equals the single-lane runs with the flag fixed, lane by lane;
* skipping idle ascents changes no leaf of a run;
* ``optimize`` on the oracle config ``lagrange-2`` (at 1e-9) and on the
  Lagrange golden trajectory;
* the static stamp (``optimized_sampling=False``): JAX's stamp, found
  through ``save_path``, gives JAX's trajectory, and the port's own stamp
  is within 1e-6 of it;
* B=4 batches against the port's single runs and the staged runner against
  the plain one.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.core.algorithm as jalg
import morbit_tpu.core.database as jdb
import morbit_tpu.models.lagrange as jlag
import morbit_tpu_torch as mt
import morbit_tpu_torch.core.database as tdb
import morbit_tpu_torch.models.lagrange as tlag
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu.core.mop import compile_mop as jax_compile_mop
from morbit_tpu.models.base import ModelContext as JaxContext
from morbit_tpu.models.configs import LagrangeConfig as JaxLagrange
from morbit_tpu.utils.logging import trajectory_arrays as jax_trajectory_arrays
from morbit_tpu.utils.parity import compare_trajectories
from morbit_tpu_torch.core import scaling
from morbit_tpu_torch.core.algorithm import Solver
from morbit_tpu_torch.core.mop import compile_mop
from morbit_tpu_torch.models.base import ModelContext
from morbit_tpu_torch.models.configs import LagrangeConfig
from morbit_tpu_torch.utils.carry import state_to_numpy
from morbit_tpu_torch.utils.parity import export_trajectory
from tests.oracle_full import GroupState
from tests.torch_families import (F64, GOLDEN_X0, X0, assert_batch_equals_singles_and_staged,
                                  assert_matches_oracle, assert_records_equal, lane_record,
                                  oracle_groups, parabolas)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_monomial_exponents_match_jax(n):
    for degree in (1, 2):
        np.testing.assert_array_equal(tlag.monomial_exponents(n, degree),
                                      jlag.monomial_exponents(n, degree))


def _ops(degree=2, **cfg_kw):
    solver = Solver(compile_mop(parabolas(LagrangeConfig(degree=degree, **cfg_kw))),
                    mt.AlgorithmConfig(max_iter=8), F64, "cpu")
    return solver, solver.container.ops[0]


def test_ascent_gradient_matches_jax_grad():
    """The closed-form gradient of |b . phi(u)| equals ``jax.grad``'s,
    also at a zero of the polynomial, where both take the sign +1."""
    _, ops = _ops()
    jops = jalg.Solver(jax_compile_mop(parabolas(JaxLagrange(), port=False)),
                       JaxConfig(), jnp.float64).container.ops[0]
    rng = np.random.default_rng(4)
    b = rng.normal(size=(3, 6))
    U = rng.uniform(size=(3, 5, 2))
    b[2] = [0.0, 1.0, -1.0, 0.0, 0.0, 0.0]        # l = u_0 - u_1
    U[2, 0] = [0.25, 0.25]                        # a zero of l
    g = ops._abs_grad(torch.as_tensor(b), torch.as_tensor(U)).numpy()
    for i in range(3):
        for k in range(5):
            ref = jax.grad(lambda u: jnp.abs(jnp.asarray(b[i]) @ jops._phi(u)))(
                jnp.asarray(U[i, k]))
            np.testing.assert_allclose(g[i, k], np.asarray(ref), rtol=0, atol=1e-13)
    np.testing.assert_array_equal(g[2, 0], [1.0, -1.0])


#: the database of tests/test_oracle_full_parity.py::test_lagrange_poised_set_parity
ROWS = np.array([[0.125, 0.8125], [0.0, 0.76559062], [0.325, 0.63642166], [0.325, 1.0],
                 [0.225, 0.71964286], [0.51, 0.52]])
FS = lambda xs: np.array([np.sum(((xs - 0.5) * 8 - 1.0) ** 2),
                          np.sum(((xs - 0.5) * 8 + 1.0) ** 2)])


def _port_prepare(degree, efl, lanes=1, **cfg_kw):
    solver, ops = _ops(degree, **cfg_kw)
    db = tdb.init_database(lanes, solver.db_capacity, 2, 2, F64, "cpu")
    for r in ROWS:
        db, _ = tdb.add_evaluated(db, torch.as_tensor(r).expand(lanes, 2),
                                  torch.as_tensor(FS(r)).expand(lanes, 2))
    scal = scaling.VarScaler(*(f.expand(lanes, 2) for f in solver.scal))
    ctx = ModelContext(x_s=torch.as_tensor(ROWS[4]).expand(lanes, 2),
                       x_index=torch.full((lanes,), 4, dtype=torch.int32),
                       delta=torch.full((lanes,), 0.2, dtype=F64),
                       n_evals=torch.full((lanes,), 6, dtype=torch.int32), scal=scal)
    return ops.prepare(ops.init_state(lanes, "cpu"), db, ctx, efl)


def _jax_prepare(degree, efl, **cfg_kw):
    solver = jalg.Solver(jax_compile_mop(parabolas(JaxLagrange(degree=degree, **cfg_kw),
                                                   port=False)),
                         JaxConfig(max_iter=8), jnp.float64)
    ops = solver.container.ops[0]
    db = jdb.init_database(solver.db_capacity, 2, 2, jnp.float64)
    for r in ROWS:
        db, _ = jdb.add_evaluated(db, jnp.asarray(r), jnp.asarray(FS(r)))
    ctx = JaxContext(x_s=jnp.asarray(ROWS[4]), x_index=jnp.asarray(4, jnp.int32),
                     delta=jnp.asarray(0.2), n_evals=jnp.asarray(6, jnp.int32),
                     scal=solver.scal, key=jax.random.PRNGKey(0))
    return jax.jit(lambda s, d: ops.prepare(s, d, ctx, efl))(ops.init_state(), db)


@pytest.mark.parametrize("degree", [1, 2])
def test_poised_set_matches_oracle_and_jax(degree):
    """One poised-set construction from the same database: the point
    sources equal the oracle's and JAX's; the sites the ascent generated
    are within 1e-6 of both (their greedy step paths differ by ulps)."""
    st, db = _port_prepare(degree, False)
    new = db.X[0, len(ROWS):int(db.count[0])].numpy()
    jst, jdb2 = _jax_prepare(degree, False)
    g = GroupState(oracle_groups("lagrange", lag_degree=degree)[0], 2, np.zeros(2), np.ones(2),
                   np.full(2, 1 / 8), np.full(2, 0.5), 0.5)
    for r in ROWS:
        g.db.add(r, FS(r))
    g._lag_prepare(np.asarray(ROWS[4]), 4, 0.2)
    assert st.idx[0].tolist() == g.idx == np.asarray(jst.idx).tolist()
    orc_new = np.array([g.db.X[i] for i in range(len(ROWS), g.db.count)]).reshape(-1, 2)
    jax_new = np.asarray(jdb2.X)[len(ROWS):int(jdb2.count)]
    assert new.shape == orc_new.shape == jax_new.shape
    if new.size:
        assert np.abs(new - orc_new).max() <= 1e-6
        assert np.abs(new - jax_new).max() <= 1e-6
    assert bool(st.fully_linear[0])


def test_ensure_fully_linear_per_lane_equals_static():
    """``allow_not_linear=True``: lanes asking for a fully linear set run
    Algorithm 6.3 and are flagged fully linear, the others not; each lane
    of the masked batch equals the single-lane run with its flag fixed
    (the lock of tests/test_traced_efl.py), and JAX's static prepare on
    the sources."""
    efl = torch.tensor([True, False, False, True])
    st, db = _port_prepare(2, efl, lanes=4, allow_not_linear=True)
    for flag in (True, False):
        one, db1 = _port_prepare(2, flag, allow_not_linear=True)
        jst, _ = _jax_prepare(2, flag, allow_not_linear=True)
        for lane in np.nonzero(efl.numpy() == flag)[0]:
            for name in one._fields:
                np.testing.assert_array_equal(getattr(st, name)[lane].numpy(),
                                              getattr(one, name)[0].numpy(), err_msg=name)
            np.testing.assert_array_equal(db.data[lane].numpy(), db1.data[0].numpy())
            assert int(db.count[lane]) == int(db1.count[0])
            assert bool(st.fully_linear[lane]) == flag == bool(jst.fully_linear)
        assert one.idx[0].tolist() == np.asarray(jst.idx).tolist()


def test_skipping_idle_ascents_changes_nothing(monkeypatch):
    """The skips of Algorithm 6.2's unneeded ascents and of Algorithm 6.3's
    passes once every lane is done give the same state, leaf by leaf, as
    running them all."""
    runs = []
    for skip in (True, False):
        monkeypatch.setattr(tlag, "SKIP_IDLE_ASCENTS", skip)
        res = mt.multistart_optimize(parabolas(LagrangeConfig(degree=2)),
                                     np.array([[-3.0, 2.5], [1.5, -0.5], [3.9, 3.9]]),
                                     mt.AlgorithmConfig(max_iter=4), dtype=F64, device="cpu")
        runs.append(state_to_numpy(res.state))
    assert runs[0].keys() == runs[1].keys()
    for name in runs[0]:
        np.testing.assert_array_equal(runs[0][name], runs[1][name], err_msg=name)


def test_optimize_matches_full_oracle():
    assert_matches_oracle(LagrangeConfig(degree=2), oracle_groups("lagrange", lag_degree=2),
                          1e-9, max_iter=8)


def test_trajectory_matches_lagrange2_golden():
    """The golden's iterates (within 1e-10), radii and iteration types. Its
    evaluation count is one higher: a candidate pick between |l_i| values
    that tie in exact arithmetic follows the last bit of the dot products,
    which the port adds in index order and XLA's CPU product with fused
    multiply-adds, so one poised set takes one ascent site more in the
    golden's run (ROADMAP 3.7)."""
    res = mt.optimize(parabolas(LagrangeConfig(degree=2)), GOLDEN_X0, max_iter=15,
                      device="cpu", dtype=F64)
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "two_parabolas_lagrange2_f64.json")) as f:
        golden = json.load(f)
    rep = compare_trajectories(export_trajectory(res), golden, x_tol=1e-10)
    assert rep["len_ours"] == rep["len_reference"]
    assert rep["max_x_err"] <= 1e-10 and rep["stat_mismatches"] == []
    np.testing.assert_allclose(export_trajectory(res)["delta"], golden["delta"], rtol=0,
                               atol=1e-10)
    assert (int(res.n_evals), golden["n_evals"]) == (25, 26)


def _static_runs(tmp_path, port_cfg_path):
    """The static-stamp runs of both packages, JAX's stamp on disk."""
    kw = dict(max_iter=6)
    jcfg = JaxLagrange(degree=2, optimized_sampling=False, save_path=str(tmp_path))
    ref = jalg.optimize(parabolas(jcfg, port=False), jnp.asarray(X0), dtype=jnp.float64, **kw)
    tlag.LagrangeOps._stamp_cache.clear()
    port = mt.optimize(parabolas(LagrangeConfig(degree=2, optimized_sampling=False,
                                                save_path=port_cfg_path)),
                       X0, device="cpu", dtype=F64, **kw)
    return port, ref


def test_static_stamp_from_jax_matches_jax(tmp_path):
    """``optimized_sampling=False``: the port finds the stamp JAX wrote under
    ``save_path`` (same file name and layout) and runs JAX's trajectory;
    its own stamp, built at float64, is within 1e-6 of JAX's."""
    port, ref = _static_runs(tmp_path, str(tmp_path))
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["lagrange_stamp_n2_d2_lam1.5_r8_i40_f64.npz"]
    tr = jax_trajectory_arrays(ref)
    assert_records_equal(lane_record(port), dict(
        stop_code=int(ref.stop_code), n_iterations=int(ref.n_iterations),
        n_evals=[int(g.n_evals) for g in ref.state.groups], it_stat=tr["it_stat"].tolist(),
        x_indices=tr["x_indices"].tolist(), x=tr["x"], fx=tr["fx"],
        x_final=np.asarray(ref.x)), 1e-10)
    assert bool(port.state.groups[0].model.fully_linear)
    with np.load(tmp_path / files[0]) as dat:
        jpts, jB = dat["points"], dat["B"]
    tlag.LagrangeOps._stamp_cache.clear()
    _, ops = _ops(2, optimized_sampling=False)
    pts, B = ops._static_stamp()
    assert np.abs(pts - jpts).max() <= 1e-6
    assert np.abs(B - jB).max() <= 1e-6


@pytest.mark.parametrize("cfg", [LagrangeConfig(degree=2), LagrangeConfig(degree=1),
                                 LagrangeConfig(degree=2, allow_not_linear=True),
                                 LagrangeConfig(degree=2, optimized_sampling=False)],
                         ids=["deg2", "deg1", "allow-not-linear", "static-stamp"])
def test_batch_equals_singles_and_staged(cfg):
    res = assert_batch_equals_singles_and_staged(cfg, mt.AlgorithmConfig(max_iter=4))
    assert torch.isfinite(res.x).all()
    assert not bool(res.state.groups[0].db.overflow.any())
