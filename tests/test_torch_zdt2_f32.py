"""The float32 grid setting ``zdt2-n10-rbf_cubic-steepest_descent-s8`` (ROADMAP
3.14) against the JAX package, on the CPU.

JAX's float32 jit of this solve takes minutes here, so its run of the
second Halton start (lane 1) is recorded trip by trip in
``tests/golden/zdt2_n10_rbf_cubic_f32_lane1.npz`` by
``tests/torch_record_zdt2_f32.py``.

* From every recorded JAX state the port's ``iterate`` gives JAX's next
  state in every integer leaf, a finite omega at every stamp, and JAX's
  stop: CRITICAL at iteration 4 with 57 evaluations.
* What parts the free runs is the reference's own: at a box corner round 3
  proposes the center itself along a coordinate whose other coordinates lie
  on the bound (``intersect_box`` gives 0 for a direction component 0 on
  the bound), in both packages, and a training set holding one site
  several times fits non-finitely in the port exactly where it does in
  JAX.
* The port's own states before a lane's first non-finite fit (lane 1 of
  the free CPU run, lane 3 of the card's batch of 8), saved by
  ``morbit_tpu_torch/tools/nan_fit_states.py``, with JAX's trip from each,
  recorded in ``tests/golden/zdt2_n10_rbf_cubic_f32_nan_fits.npz``: from
  those very states JAX's fit is non-finite too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.models.rbf_model as jrbfm
import morbit_tpu_torch.parallel.benchmarks as tb
from morbit_tpu.ops.rbf import fit_rbf as jax_fit_rbf
from morbit_tpu_torch.core.enums import STOP_CODE
from morbit_tpu_torch.ops.prepare_coord import rbf_selection_core
from morbit_tpu_torch.ops.rbf import fit_rbf
from morbit_tpu_torch.parallel.multistart import build_solver
from morbit_tpu_torch.utils.carry import state_from_numpy, state_to_numpy
from torch_record_zdt2_f32 import NAN_FITS_PATH, PATH, SETTING

N, M = 10, 2
#: JAX's fit at the recorded shapes, compiled once a dtype
_JAX_FIT = jax.jit(jax.vmap(lambda s, v, m: jax_fit_rbf(s, v, m, kernel="cubic", param=3.0)))


@pytest.fixture(scope="module")
def recorded():
    """JAX's states of lane 1, trip 0 (initial) to the stop."""
    g = np.load(PATH)
    trips = 1 + max(int(k.split("/")[0]) for k in g.files)
    return [{k.split("/", 1)[1]: g[k] for k in g.files if k.startswith(f"{t}/")}
            for t in range(trips)]


@pytest.fixture(scope="module")
def nan_fits():
    """By tag: the port's state before the trip of a lane's first
    non-finite fit, the port's state after it, and JAX's after it."""
    g = np.load(NAN_FITS_PATH)
    tags = sorted({k.split("/")[0] for k in g.files})
    return {tag: {part: {k.split("/", 2)[2]: g[k] for k in g.files
                         if k.startswith(f"{tag}/{part}/")}
                  for part in ("before", "port_after", "jax_after")} for tag in tags}


def _solver():
    s = tb.Setting(*SETTING)
    return build_solver(tb.make_problem(s.problem, s.n_vars, s.model),
                        tb._default_config(s), torch.float32, "cpu")


def _training_set(leaves, dtype):
    """The sites, values and mask of a state's RBF fit (its database rows
    picked by the model's indices)."""
    fd = leaves["groups.0.model.fit.fdata"]
    idx = leaves["groups.0.model.meta"][0, :fd.shape[1]]
    db = leaves["groups.0.db.data"][0]
    mask = fd[..., N + M] > 0.5
    values = np.where(mask[0][:, None], db[np.clip(idx, 0, len(db) - 1), N:N + M], 0)
    return fd[..., :N].astype(dtype), values[None].astype(dtype), mask


def _fit_finite(leaves):
    return bool(np.isfinite(leaves["groups.0.model.fit.fdata"]).all()
                & np.isfinite(leaves["groups.0.model.fit.flam"]).all())


def _omega_stamps(leaves):
    count = int(leaves["traj.count"][0])
    return leaves["traj.data"][0, 1:count, N + M + 2]   # the initial stamp has -inf


def test_lockstep_from_recorded_jax_states(recorded):
    """Each trip of the port from JAX's state: JAX's integers (stop code,
    iteration, criticality mode and loops, x indices, database fills,
    evaluation counters, training-set rows and flags) and a finite omega
    at every stamp; the last trip stops CRITICAL at iteration 4 with 57
    evaluations, as JAX's run does."""
    solver = _solver()
    assert len(recorded) == 11
    for t, (before, after) in enumerate(zip(recorded, recorded[1:])):
        port = state_to_numpy(solver.iterate(state_from_numpy(before, device="cpu")))
        assert set(port) == set(after)
        for name, a in port.items():
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, after[name], err_msg=f"trip {t}: {name}")
        assert np.isfinite(_omega_stamps(port)).all(), t
    last = recorded[-1]
    assert int(port["ints"][0, 2]) == int(last["ints"][0, 2]) == STOP_CODE.CRITICAL
    assert int(port["ints"][0, 0]) - 1 == 4
    assert int(port["groups.0.n_evals"][0]) == 57
    assert np.isfinite(port["fx"]).all() and np.isfinite(port["groups.0.model.fit.fdata"]).all()


def test_round3_at_a_corner_proposes_the_center_as_jax_does():
    """A rebuild along the coordinates at x = (0, 0, 0.3) in [0, 1]^3: along
    e_0 and e_1 the other coordinate lies on the bound with a direction
    component of 0, so both box exits are 0 and the proposed site is x
    itself; along e_2 the larger exit is -0.3. The port's selection equals
    JAX's ``rbf_selection_core`` (the mechanism by which lane 1's free runs
    hold one site several times)."""
    n, cap = 3, 8
    X = np.zeros((1, cap, n), np.float32)
    X[0, 0] = [0.0, 0.0, 0.3]
    X[0, 1] = [0.05, 0.0, 0.3]
    args = [X, np.array([2], np.int32), X[:, 0].copy(), np.array([0], np.int32),
            np.array([0.5], np.float32), np.zeros((1, n), np.float32),
            np.ones((1, n), np.float32), np.array([50], np.int32), np.array([True])]
    statics = dict(theta_e1=2.0, theta_e2_dmax=1.0, theta_pivot=0.25, delta_max=0.5,
                   skip2_same_theta=True)
    port = rbf_selection_core(*[torch.as_tensor(a) for a in args], **statics)
    ref = jrbfm.rbf_selection_core(*map(jnp.asarray, [a[0] for a in args[:8]]),
                                   ensure_fully_linear=bool(args[8][0]), n=n, **statics)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p[0].numpy(), np.asarray(r))
    sites = port[4][0].numpy()
    np.testing.assert_array_equal(sites[:2], X[0, [0, 0]])
    np.testing.assert_array_equal(sites[2], [0.0, 0.0, 0.0])


@pytest.mark.parametrize("copies", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_fit_with_a_site_repeated_agrees_with_jax(recorded, dtype, copies):
    """JAX's training set of iteration 4 (21 sites, cubic kernel, linear
    tail) fits finitely in both packages. With its first site repeated
    ``copies`` times in the next slots the KKT system is singular and the
    ridge on the tail does not mend it: the port's fit is non-finite exactly
    where JAX's is. With three more copies (four in all, as lane 1's free
    runs hold one site) both are non-finite at either precision; with one,
    float32 rounding leaves both finite with weights near 1e7."""
    sites, values, mask = _training_set(recorded[4], dtype)
    k = int(mask.sum())
    assert k == 21
    dup_sites, dup_values, dup_mask = sites.copy(), values.copy(), mask.copy()
    dup_sites[0, k:k + copies] = sites[0, 0]
    dup_values[0, k:k + copies] = values[0, 0]
    dup_mask[0, k:k + copies] = True
    seen = []
    for s_, v_, m_ in ((sites, values, mask), (dup_sites, dup_values, dup_mask)):
        ours = fit_rbf(torch.as_tensor(s_), torch.as_tensor(v_), torch.as_tensor(m_),
                       kernel="cubic", param=3.0)
        theirs = _JAX_FIT(jnp.asarray(s_), jnp.asarray(v_), jnp.asarray(m_))
        finite = bool(torch.isfinite(ours.w).all() & torch.isfinite(ours.lam).all())
        assert finite == bool(np.isfinite(np.asarray(theirs.fdata)).all()
                              & np.isfinite(np.asarray(theirs.flam)).all())
        seen.append(finite)
    assert seen[0]
    assert seen[1] is (copies == 1 and dtype == np.float32)


#: recorded states from which round 4 accepts more sites in the port than in
#: JAX: (the port's training rows, JAX's). On the card's lane 3, rounds 1-3
#: already hold one site three times, so round 4 tests its candidates
#: against a rank-deficient basis, where tau^2 against 1e-28 is rounding
#: noise (ROADMAP 3.6): the port accepts rows 16 and 17, JAX neither
ROUND4_NOISE = {"card_lane3": (15, 13)}


@pytest.mark.parametrize("tag", ["cpu_lane1", "card_lane3"])
def test_port_state_fits_non_finitely_in_jax_too(nan_fits, tag):
    """From the port's own state before a lane's first non-finite fit (the
    free CPU run's lane 1, alone; the card's lane 3 of 8), the port's trip
    on the CPU equals JAX's trip from the same state in every integer leaf,
    and the recorded trip of the device the state came from: the database
    holds one site several times, both fits are non-finite, omega is -inf
    and the lane stops TOLERANCE, in the port and in JAX. JAX's and the
    port's ``fit_rbf`` of that training set are both non-finite. On the
    card's lane 3, round 4 accepts more sites in the port than in JAX
    (ROUND4_NOISE); the rows before them are the same."""
    rec = nan_fits[tag]
    port = state_to_numpy(_solver().iterate(state_from_numpy(rec["before"], device="cpu")))
    for name, a in port.items():
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, rec["port_after"][name], err_msg=name)
            if name != "groups.0.model.meta" or tag not in ROUND4_NOISE:
                np.testing.assert_array_equal(a, rec["jax_after"][name], err_msg=name)
    if tag in ROUND4_NOISE:
        ours, theirs = port["groups.0.model.meta"][0], rec["jax_after"]["groups.0.model.meta"][0]
        P = port["groups.0.model.fit.fdata"].shape[1]
        k = int(theirs[P])
        assert (int(ours[P]), k) == ROUND4_NOISE[tag]
        np.testing.assert_array_equal(ours[:k], theirs[:k])
        np.testing.assert_array_equal(ours[P + 1:], theirs[P + 1:])
    X = port["groups.0.db.data"][0, :int(port["groups.0.db.count"][0]), :N]
    assert len(np.unique(X, axis=0)) < len(X)
    for leaves in (port, rec["jax_after"]):
        assert not _fit_finite(leaves)
        count = int(leaves["traj.count"][0])
        assert leaves["traj.data"][0, count - 1, N + M + 2] == -np.inf
        assert int(leaves["ints"][0, 2]) == STOP_CODE.TOLERANCE
    sites, values, mask = _training_set(port, np.float32)
    ours = fit_rbf(torch.as_tensor(sites), torch.as_tensor(values), torch.as_tensor(mask),
                   kernel="cubic", param=3.0)
    theirs = _JAX_FIT(jnp.asarray(sites), jnp.asarray(values), jnp.asarray(mask))
    assert not bool(torch.isfinite(ours.w).all() & torch.isfinite(ours.lam).all())
    assert not bool(np.isfinite(np.asarray(theirs.fdata)).all()
                    & np.isfinite(np.asarray(theirs.flam)).all())
