"""The port's staged multistart runner, its probe helpers, its bench and its
entry point, at float64 on the CPU.

* the probe helpers (``suggest_schedule``, ``suggest_widths``,
  ``suggest_db_capacity``, ``capacity_overflowed``) and the stage
  capacities (``_cap_at``, ``_traj_cap_at``) against the JAX package's on
  the same inputs (no JAX program is compiled);
* ``StagedMultistart`` against the port's plain ``multistart_optimize``
  lane by lane (the pattern of ``tests/test_multistart.py``): integers
  exact, floats within 1e-12 after ``canonicalize_buffer_tails``, for
  capacity stages with and without the fleet loop and for compacted,
  starving and to-completion widths; the probe protocol at a tuned
  capacity within 1e-9; the sticky overflow flag at a capacity too small;
* the argument checks of ``StagedMultistart``;
* the bench twin (``morbit_tpu_torch/bench.py``) at a tiny size: the key
  set of ``bench.py`` and the overflow flag OR'ed over every batch;
* ``entry()`` on the CPU.
"""

import ast
import contextlib
import io
import json
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.parallel.multistart as jms
import morbit_tpu.problems.synthetic as jsyn
import morbit_tpu_torch as mt
import morbit_tpu_torch.bench as tbench
import morbit_tpu_torch.parallel.multistart as tms
import morbit_tpu_torch.problems.synthetic as tsyn
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu.models.configs import RbfConfig as JaxRbf
from morbit_tpu_torch.entry import entry
from morbit_tpu_torch.models.configs import RbfConfig
from morbit_tpu_torch.utils.carry import state_to_numpy

LB2, UB2 = [-4.0, -4.0], [4.0, 4.0]
F64 = torch.float64
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _mop():
    return tsyn.make_two_parabolas(RbfConfig(kernel="multiquadric"), LB2, UB2)


def _ac(**kw):
    return mt.AlgorithmConfig(**{"max_iter": 12, "qp_iters": 100, **kw})


# --------------------------------------------------------------- probe helpers

#: per-lane iteration counts of a probe: a spread, a degenerate probe whose
#: every lane ran the whole budget, and a seeded 1024-lane fleet
PROBES = {
    "spread": np.array([1, 2, 3, 3, 4, 6, 8, 11] * 4),
    "degenerate": np.full(16, 12),
    "fleet1024": np.random.default_rng(0).integers(1, 13, 1024),
    "early": np.array([0, 0, 1, 1, 1, 2, 2, 12]),
}


def _probe_result(counts, overflow):
    """A duck-typed result: what the helpers read of ``state.groups``."""
    groups = tuple(types.SimpleNamespace(db=types.SimpleNamespace(count=c, overflow=o))
                   for c, o in zip(counts, overflow))
    return types.SimpleNamespace(state=types.SimpleNamespace(groups=groups))


@pytest.mark.parametrize("helper", ["schedule", "widths", "db_capacity", "overflowed"])
@pytest.mark.parametrize("probe", PROBES)
def test_probe_helpers_match_jax(probe, helper):
    """The port's probe helpers equal the JAX package's on the same numpy
    inputs, over their keyword arguments."""
    ni = PROBES[probe]
    B = ni.shape[0]
    if helper == "schedule":
        for n_stages in (2, 4, 5):
            assert (tms.suggest_schedule(torch.as_tensor(ni), 12, n_stages)
                    == jms.suggest_schedule(ni, 12, n_stages))
    elif helper == "widths":
        sched = jms.suggest_schedule(ni, 12)
        runner = types.SimpleNamespace(schedule=tuple((t, None) for t in sched))
        for kw in (dict(), dict(quantum=2), dict(slack=1.0, quantum=1), dict(batch=B + 5)):
            assert (tms.suggest_widths(runner, torch.as_tensor(ni), **kw)
                    == jms.suggest_widths(runner, ni, **kw))
    else:
        rng = np.random.default_rng(B)
        counts = [rng.integers(1, 3 * ni.max() + 2, B).astype(np.int32) for _ in range(2)]
        overflow = [np.zeros(B, bool), np.arange(B) == B - 1]
        for flags in (overflow[:1] * 2, overflow):
            port = _probe_result([torch.as_tensor(c) for c in counts],
                                 [torch.as_tensor(o) for o in flags])
            ref = _probe_result(counts, flags)
            if helper == "overflowed":
                assert tms.capacity_overflowed(port) == jms.capacity_overflowed(ref)
                continue
            for kw in (dict(), dict(quantum=8), dict(margin=1.0, quantum=1)):
                assert (tms.suggest_db_capacity(port, **kw)
                        == jms.suggest_db_capacity(ref, **kw))


@pytest.mark.parametrize("kw", [dict(max_iter=100, qp_iters=400), dict(max_iter=10),
                                dict(max_iter=100, db_capacity=64),
                                dict(max_iter=100, trajectory_capacity=40)])
def test_stage_capacities_match_jax(kw):
    """``_cap_at`` and ``_traj_cap_at`` of the main path's solver equal the
    JAX package's at every bound up to the budget, and the solvers'
    capacities agree."""
    jsolver = jms.build_solver(jsyn.make_two_parabolas(JaxRbf(kernel="multiquadric"),
                                                       LB2, UB2),
                               JaxConfig(**kw), jnp.float64)
    solver = tms.build_solver(_mop(), mt.AlgorithmConfig(**kw), F64, "cpu")
    assert (solver.db_capacity, solver.T) == (jsolver.db_capacity, jsolver.T)
    for t in range(1, kw["max_iter"] + 1):
        assert tms._cap_at(solver, t) == jms._cap_at(jsolver, t)
        assert tms._traj_cap_at(solver, t) == jms._traj_cap_at(jsolver, t)


# ------------------------------------------------------ staged against plain

@pytest.fixture(scope="module")
def plain():
    """The plain runner on 8 Halton starts, max_iter=12: the reference of
    every staged run below."""
    x0 = tsyn.halton_starts(8, LB2, UB2)
    return x0, tms.multistart_optimize(_mop(), x0, _ac(), dtype=F64, device="cpu")


def _assert_lanes_equal(res, ref, tol):
    """Leaf by leaf after ``canonicalize_buffer_tails``: integer leaves
    equal, float leaves within ``tol`` (non-finite values equal)."""
    a = state_to_numpy(tms.canonicalize_buffer_tails(res.state))
    b = state_to_numpy(tms.canonicalize_buffer_tails(ref.state))
    assert a.keys() == b.keys()
    for name in a:
        va, vb = a[name], b[name]
        assert va.dtype == vb.dtype and va.shape == vb.shape, name
        if va.dtype.kind in "biu":
            np.testing.assert_array_equal(va, vb, err_msg=name)
        else:
            np.testing.assert_allclose(va, vb, rtol=0, atol=tol, err_msg=name)
    for name in ("stop_code", "n_iterations", "n_evals"):
        np.testing.assert_array_equal(getattr(res, name).numpy(), getattr(ref, name).numpy())


#: (fleet, widths): capacity stages alone, with the fleet loop, and compacted
#: widths (generous, starving at 1, a compacted to-completion stage)
STAGED = {"fleet_off": (False, None), "fleet_on": (None, None),
          "widths_8_6": (None, (8, 6)), "widths_4_1": (None, (4, 1)),
          "widths_8_4_4": (None, (8, 4, 4))}


@pytest.mark.parametrize("variant", STAGED)
def test_staged_matches_plain(plain, variant):
    """``StagedMultistart`` with schedule (3, 6) equals the plain runner
    lane by lane: integers exact, floats within 1e-12."""
    x0, ref = plain
    fleet, widths = STAGED[variant]
    run = tms.StagedMultistart(_mop(), _ac(), F64, schedule=(3, 6), fleet=fleet,
                               widths=widths, device="cpu")
    assert run.fleet == (fleet is None)
    assert len(run.schedule) == 2
    # the stages run below the full capacities
    assert run.schedule[0][1][0] < run.solver.db_capacity
    assert run.schedule[0][1][1] < run.solver.T
    res = run(x0)
    _assert_lanes_equal(res, ref, 1e-12)
    assert res.trips == sum(res.stage_trips) >= ref.trips
    assert len(res.stage_trips) == len(run.schedule) + 1 + (len(widths or ()) == 3)


def test_probe_protocol_matches_probe(plain):
    """A ``tuned(db_capacity=suggest_db_capacity(...))`` run reproduces the
    probe (integers and fill counts exact, x and fx within 1e-9); a capacity
    of 8 rows raises the sticky overflow flag."""
    x0, _ = plain
    probe = tms.StagedMultistart(_mop(), _ac(), F64, device="cpu")
    ref = probe(x0)
    assert not tms.capacity_overflowed(ref)
    cap = tms.suggest_db_capacity(ref, quantum=8)
    assert cap < probe.solver.db_capacity
    run = probe.tuned(ref.n_iterations, quantum=2, db_capacity=cap)
    assert run.solver.db_capacity == cap and run.widths is not None
    res = run(x0)
    assert not tms.capacity_overflowed(res)
    for name in ("stop_code", "n_iterations", "n_evals"):
        np.testing.assert_array_equal(getattr(res, name).numpy(), getattr(ref, name).numpy())
    for name in ("x", "fx"):
        np.testing.assert_allclose(getattr(res, name).numpy(), getattr(ref, name).numpy(),
                                   rtol=1e-9, atol=1e-9)
    for ga, gb in zip(res.state.groups, ref.state.groups):
        np.testing.assert_array_equal(ga.db.count.numpy(), gb.db.count.numpy())
        np.testing.assert_array_equal(ga.n_evals.numpy(), gb.n_evals.numpy())
    tiny = probe.tuned(ref.n_iterations, quantum=2, db_capacity=8)
    assert tms.capacity_overflowed(tiny(x0))


@pytest.mark.parametrize("bad", [dict(widths=(4,)), dict(widths=(4, 4, 4, 4)),
                                 dict(widths=(4, 0)),
                                 dict(fleet=True, ac=dict(use_db=False))])
def test_staged_rejects_bad_arguments(bad):
    """Widths of the wrong length or below 1, and the fleet loop on a config
    whose buffers are not append-only, raise as in the JAX package."""
    bad = dict(bad)
    ac = _ac(**bad.pop("ac", {}))
    with pytest.raises(ValueError):
        tms.StagedMultistart(_mop(), ac, F64, schedule=(3, 6), device="cpu", **bad)


# ------------------------------------------------------ bench twin and entry

def _bench_keys():
    """The keys of ``bench.py``'s JSON line and of its ``ref_budget``, read
    from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fns = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    keys = lambda d: {k.value for k in d.keys}
    head = next(n.args[0] for n in ast.walk(fns["main"]) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")
    ref = next(n.value for n in ast.walk(fns["_ref_budget_point"])
               if isinstance(n, ast.Return))
    return keys(head), keys(ref)


def test_bench_twin_keys_and_overflow_or(monkeypatch):
    """The bench twin on the CPU at B=8 and tiny budgets prints one JSON
    line with exactly ``bench.py``'s keys; an overflow raised in the
    headline's warm-up batch alone reaches its ``capacity_overflow``."""
    monkeypatch.setattr(tbench, "HEADLINE", dict(max_iter=4, qp_iters=50))
    monkeypatch.setattr(tbench, "REF_BUDGET", dict(max_iter=5, qp_iters=50))
    calls = []
    call = tms.StagedMultistart.__call__

    def flag_warm_up(self, x0):
        res = call(self, x0)
        calls.append(self)
        if len(calls) == 2:        # the probe, then the tuned runner's warm-up
            res.state.groups[0].db.overflow[3] = True
        return res

    monkeypatch.setattr(tms.StagedMultistart, "__call__", flag_warm_up)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tbench.main(["--device", "cpu", "--batch", "8", "--n-rep", "2"]) == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    head_keys, ref_keys = _bench_keys()
    assert set(line) == head_keys and set(line["ref_budget"]) == ref_keys
    # probe, warm-up, blocked and sustained batches (two, then one)
    assert len(calls) == 5 + 4 and calls[1] is calls[4] and calls[0] is not calls[1]
    assert line["capacity_overflow"] is True
    assert line["ref_budget"]["capacity_overflow"] is False
    assert line["unit"] == "runs/s" and line["value"] > 0


def test_entry_runs_one_iteration_on_cpu():
    """``entry(device='cpu')`` returns one batched iterate of the main path
    and its state at B=8."""
    fn, args = entry(device="cpu")
    (state,) = args
    out = fn(*args)
    assert out.x.shape == (8, 2) and out.x.device.type == "cpu"
    assert out.x.dtype == torch.float32
    assert bool((out.iter_counter == state.iter_counter + 1).all())
    assert bool(torch.isfinite(out.fx).all())
