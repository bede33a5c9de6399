"""Batched multistart optimization: the plain, staged, compacted and
parametric runners, and their mesh form.

Counterpart of ``morbit_tpu/parallel/multistart.py``: one optimize() per
row of a (B, n) batch of starts, run as B lanes of one batched solve (the
reference's ``Threads.@threads`` benchmark loop,
``examples/large_scale_benchmarks.jl:253-275``).

* :func:`multistart_optimize` runs every lane to its stop code at the
  worst-case database capacity.
* :class:`StagedMultistart` runs the early iterations at the capacity their
  iteration bound implies (capacity stages), lets the append-only buffers
  skip the per-trip lane select (the fleet loop), and runs each stage on
  the lanes still active only (lane compaction, ``widths``). Its probe
  helpers (:func:`suggest_db_capacity`, :func:`suggest_schedule`,
  :func:`suggest_widths`) tune it from a first run.
* :class:`CompactedMultistart` runs fixed-length stages and, between them,
  shrinks the batch to the smallest bucket of a ladder that holds every
  lane still running, with a growing database capacity.
* :func:`parametric_multistart` solves a different problem instance per
  lane: the problem's functions take per-lane data θ
  (``core/parametric.py``).

Each stage is a host loop of :meth:`Solver.iterate` trips with one host
sync a trip, like ``Solver.solve_from_state`` with a trip bound. Host
(NumPy) functions evaluate each lane's kept sites only, so compaction and
the fleet loop send the same sites to the host as the plain runner.

A ``mesh`` (the JAX package's 1-D device mesh over the batch axis) is a
sequence of ``torch.device``s (:func:`default_mesh`: every CUDA device).
The batch splits into as many contiguous shards as the mesh has entries
(B must divide by that number, JAX's rule), and each shard runs on its
device as a batch of its own: lanes are independent, so no collective is
needed. Shards on distinct devices run in one host thread per device,
shards on the same device one after another; the results are put back in
lane order on the mesh's first device, and ``trips`` is the largest over
the shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from morbit_tpu_torch.core.algorithm import (OptimizeResult, Solver,
                                             _full_precision_matmuls,
                                             resolve_device)
from morbit_tpu_torch.core.config import AlgorithmConfig
from morbit_tpu_torch.core.enums import STOP_CODE
from morbit_tpu_torch.core.mop import CompiledMOP, compile_mop
from morbit_tpu_torch.core.parametric import cast_leaf, flatten, parametric_mop
from morbit_tpu_torch.utils.tree import lane_where, tree_map


# ------------------------------------------------------------------- the mesh

def default_mesh() -> tuple:
    """Every CUDA device, as a mesh over the batch axis (JAX's
    ``default_mesh``: every device). Raises without one."""
    resolve_device(None)
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def mesh_devices(mesh: Sequence) -> tuple:
    """The mesh's entries as ``torch.device``s (a CUDA entry without a card
    raises, as every entry point's default does)."""
    devs = tuple(resolve_device(d) for d in mesh)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def shard_bounds(B: int, n_shards: int) -> list:
    """The ``(start, stop)`` lanes of each contiguous shard; B must divide
    by the number of shards (JAX's sharding rule)."""
    if B % n_shards:
        raise ValueError(f"a batch of {B} lanes does not divide over a mesh of "
                         f"{n_shards} devices")
    w = B // n_shards
    return [(i * w, (i + 1) * w) for i in range(n_shards)]


def run_sharded(devices: tuple, jobs: Sequence[Callable]) -> list:
    """``jobs[i]()`` for every shard ``i``, on ``devices[i]``: one host
    thread per distinct device (each with that device current), the jobs
    of one device one after another. Returns the results in shard order;
    the first failure is raised."""
    by_device = {}
    for i, dev in enumerate(devices):
        by_device.setdefault(dev, []).append(i)
    results, errors = [None] * len(jobs), []

    def run_device(dev, shards):
        scope = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        try:
            with scope:
                for i in shards:
                    results[i] = jobs[i]()
        except Exception as e:  # re-raised in the caller's thread below
            errors.append(e)

    if len(by_device) == 1:
        (dev, shards), = by_device.items()
        run_device(dev, shards)
    else:
        threads = [threading.Thread(target=run_device, args=item)
                   for item in by_device.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return results


def gather_results(results: Sequence[OptimizeResult], device) -> OptimizeResult:
    """The shards' results as one, lanes in shard order on ``device``;
    ``trips`` the largest over the shards, ``stage_trips`` stage by
    stage."""
    if len(results) == 1:
        return results[0]
    cat = lambda *ts: torch.cat([t.to(device) for t in ts], dim=0)
    state = tree_map(cat, results[0].state, *(r.state for r in results[1:]))
    stage_trips = tuple(max(t) for t in itertools.zip_longest(
        *(r.stage_trips for r in results), fillvalue=0))
    return OptimizeResult(
        x=state.x, fx=state.fx, stop_code=state.stop_code,
        n_iterations=cat(*(r.n_iterations for r in results)),
        n_evals=cat(*(r.n_evals for r in results)), state=state,
        trips=max(r.trips for r in results), stage_trips=stage_trips)


def on_mesh(devices: tuple, B: int, job: Callable) -> OptimizeResult:
    """``job(device, lo, hi)`` for every contiguous shard ``lo:hi`` of B
    lanes, on its device (``run_sharded``), gathered on ``devices[0]``."""
    jobs = [functools.partial(job, d, lo, hi)
            for d, (lo, hi) in zip(devices, shard_bounds(B, len(devices)))]
    return gather_results(run_sharded(devices, jobs), devices[0])


def build_solver(mop, algo_config: Optional[AlgorithmConfig] = None,
                 dtype=torch.float32, device=None) -> Solver:
    ac = algo_config or AlgorithmConfig()
    cmop = mop if isinstance(mop, CompiledMOP) else compile_mop(mop, ac.combine_models)
    return Solver(cmop, ac, dtype, resolve_device(device))


def multistart_optimize(mop, x0_batch,
                        algo_config: Optional[AlgorithmConfig] = None,
                        dtype=torch.float32, device=None, mesh=None) -> OptimizeResult:
    """Run one full optimize() per row of ``x0_batch`` (B, n), batched on
    one device (CUDA unless ``device`` says otherwise), or with ``mesh``
    sharded over its devices (the module docstring; ``device`` is then
    unused). Every field of the result carries the lane axis first."""
    if mesh is None:
        return build_solver(mop, algo_config, dtype, device).solve(x0_batch)
    devs = mesh_devices(mesh)
    x0 = torch.as_tensor(x0_batch)
    solvers = {d: build_solver(mop, algo_config, dtype, d) for d in dict.fromkeys(devs)}
    return on_mesh(devs, x0.shape[0], lambda d, lo, hi: solvers[d].solve(x0[lo:hi]))


def parametric_multistart(mop_builder: Callable, x0_batch, theta_batch,
                          algo_config: Optional[AlgorithmConfig] = None,
                          dtype=torch.float32, mesh=None, device=None) -> OptimizeResult:
    """Batch over problem data, not only over starts: lane i solves the
    problem ``mop_builder(theta_i)`` from ``x0_batch[i]``, all in one
    batched solve by the plain runner (JAX: ``jax.vmap(solver.solve)``).

    ``theta_batch`` is a tree (dicts, lists, tuples) of arrays whose leading
    axis pairs with the rows of ``x0_batch`` (B, n). Float leaves follow
    the solve dtype; integer and boolean leaves keep theirs. The builder's
    function closures may capture theta; the static structure (n, bounds,
    linear rows, groups, output widths, configs) may not depend on it: the
    builds for the first and the last lane are compared, and a difference
    raises a ``ValueError`` naming the field. Host (NumPy) functions raise.
    The per-lane theta lives in ``SolverState.theta``. ``mesh`` as for
    :func:`multistart_optimize`."""
    ac = algo_config or AlgorithmConfig()
    devs = mesh_devices(mesh) if mesh is not None else (resolve_device(device),)
    leaves, rebuild = flatten(theta_batch)
    theta = tuple(cast_leaf(a, dtype, devs[0]) for a in leaves)
    x0 = torch.as_tensor(x0_batch).to(device=devs[0], dtype=dtype)
    B = x0.shape[0]
    if any(t.dim() == 0 or t.shape[0] != B for t in theta):
        raise ValueError(f"every leaf of theta_batch needs a leading axis of {B} lanes "
                         "(one per row of x0_batch)")
    cmop = parametric_mop(mop_builder, theta, rebuild, ac.combine_models)
    solvers = {d: Solver(cmop, ac, dtype, d) for d in dict.fromkeys(devs)}
    return on_mesh(devs, B, lambda d, lo, hi: solvers[d].solve(
        x0[lo:hi].to(d), tuple(t[lo:hi].to(d) for t in theta)))


# ------------------------------------------------------------ capacity stages

def _cap_at(solver: Solver, cum_iters: int) -> int:
    """Database capacity bound after ``cum_iters`` outer iterations:
    ``resolved_db_capacity`` at ``max_iter=cum_iters`` (monotone in
    ``max_iter``), clamped to the solver's capacity. An explicit capacity
    clips the per-stage bound instead of disabling staging."""
    cap = dataclasses.replace(solver.ac, max_iter=int(cum_iters), db_capacity=-1) \
        .resolved_db_capacity(solver.mop.n_vars, *solver._cap_terms)
    return min(int(cap), int(solver.db_capacity))


def _resize_rows(data: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-row pad or trim (B, cap, w) along the capacity axis. A trim
    copies, so the full buffer is freed."""
    cap = data.shape[-2]
    if rows == cap:
        return data
    if rows < cap:
        return data[..., :rows, :].contiguous()
    pad = data.new_zeros(data.shape[:-2] + (rows - cap, data.shape[-1]))
    return torch.cat([data, pad], dim=-2)


def _resize_dbs(states, new_cap: int):
    """Resize every group database to ``new_cap`` rows. Exact: rows are
    append-only, row indices are stable under end-padding, and a trim only
    removes rows above every lane's fill count (callers pass the per-stage
    bound)."""
    groups = tuple(g._replace(db=dataclasses.replace(
        g.db, data=_resize_rows(g.db.data, new_cap))) for g in states.groups)
    return dataclasses.replace(states, groups=groups)


def _traj_cap_at(solver: Solver, cum_iters: int) -> int:
    """Trajectory row bound after ``cum_iters`` outer iterations: one stamp
    per iterate plus the initialization stamp. An explicit
    ``trajectory_capacity`` is kept as it is."""
    ac = solver.ac
    if ac.trajectory_capacity > 0:
        return solver.T
    cap = dataclasses.replace(ac, max_iter=int(cum_iters)).resolved_trajectory_capacity()
    return min(int(cap), int(solver.T))


def _resize_traj(states, new_T: int):
    """Resize the trajectory to ``new_T`` rows; exact for the reasons of
    :func:`_resize_dbs` (stamps are one-hot row writes at ``count``)."""
    traj = dataclasses.replace(states.traj, data=_resize_rows(states.traj.data, new_T))
    return dataclasses.replace(states, traj=traj)


# ----------------------------------------------------------------- fleet loop

def fleet_eligible(ac: AlgorithmConfig) -> bool:
    """Whether the fleet loop's exemption of the big buffers from the lane
    select is sound: the databases and the trajectory must be append-only
    below their fill counters, which ``use_db=False`` (rows rewritten every
    iteration) and ``var_scaler_update='model'`` (sites rescaled in place)
    break."""
    return bool(ac.use_db) and ac.var_scaler_update != "model"


def _fleet_splice_big_buffers(selected, new):
    """Take the db and trajectory ``data`` buffers of ``new`` into the
    lane-selected ``selected``: the rows a stopped lane's trip writes land
    at ``row >= count`` (its frozen fill counter), which every read masks."""
    groups = tuple(go._replace(db=dataclasses.replace(go.db, data=gn.db.data))
                   for gn, go in zip(new.groups, selected.groups))
    traj = dataclasses.replace(selected.traj, data=new.traj.data)
    return dataclasses.replace(selected, groups=groups, traj=traj)


def _select_running(running, new, old, fleet: bool):
    """The runner's per-trip lane select: lanes still running take ``new``,
    the others keep ``old``; with ``fleet`` the big buffers skip the select
    and are taken from ``new`` as they are."""
    if fleet:
        old = _fleet_splice_big_buffers(old, new)
    return tree_map(lambda a, b: a if a is b else lane_where(running, a, b), new, old)


def _run_bounded(solver: Solver, states, k: Optional[int], fleet: bool):
    """At most ``k`` trips (``None``: until every lane stopped) of
    ``Solver.iterate``, lanes frozen once they stop. A lane active at trip
    j has run exactly j trips since entry, so one trip counter bounds every
    lane as the JAX package's per-lane counters do. Returns the state and
    the trips run."""
    trips = 0
    while k is None or trips < k:
        running = states.stop_code == STOP_CODE.CONTINUE
        if not bool(running.any()):
            break
        states = _select_running(running, solver.iterate(states), states, fleet)
        trips += 1
    return states, trips


def _compact(states, order, w: int):
    """Lane compaction: sort the lanes active-first (stable, on the device)
    and split them after ``w``. Returns the head, the tail and the composed
    permutation (``states[i] = original[order[i]]``). Exact: lanes are
    independent, so a permuted slice replays each lane's own trips."""
    active = states.stop_code == STOP_CODE.CONTINUE
    perm = torch.argsort((~active).to(torch.int32), stable=True)
    states = tree_map(lambda a: a[perm], states)
    order = perm if order is None else order[perm]
    return tree_map(lambda a: a[:w], states), tree_map(lambda a: a[w:], states), order


def _rejoin(head, tail):
    return tree_map(lambda h, t: torch.cat([h, t], dim=0), head, tail)


def _run_stage(solver: Solver, states, order, w: int, k: Optional[int], fleet: bool):
    """One stage of at most ``k`` trips (:func:`_run_bounded`); below the
    full width, on the first ``w`` lanes after a stable active-first sort
    (:func:`_compact`). Returns the state, the composed permutation and the
    trips run."""
    if w >= states.x.shape[0]:
        states, trips = _run_bounded(solver, states, k, fleet)
        return states, order, trips
    head, tail, order = _compact(states, order, w)
    head, trips = _run_bounded(solver, head, k, fleet)
    return _rejoin(head, tail), order, trips


def canonicalize_buffer_tails(states):
    """Zero the rows at or past the fill counter of every group database and
    of the trajectory. Those rows are dead storage (every read masks by the
    counter); the fleet loop leaves junk there where the plain runner leaves
    zeros, so canonical states of two runners compare leaf by leaf."""
    def zero_tail(data, count):
        rows = torch.arange(data.shape[-2], device=data.device)
        keep = rows < count[..., None] if count.dim() else rows < count
        return torch.where(keep[..., None], data, torch.zeros((), dtype=data.dtype,
                                                              device=data.device))

    groups = tuple(g._replace(db=dataclasses.replace(
        g.db, data=zero_tail(g.db.data, g.db.count))) for g in states.groups)
    traj = dataclasses.replace(states.traj,
                               data=zero_tail(states.traj.data, states.traj.count))
    return dataclasses.replace(states, groups=groups, traj=traj)


# ------------------------------------------------------------- staged runner

class StagedMultistart:
    """Staged-capacity multistart with the fleet loop and lane compaction.

    The plain runner allocates every database at the worst-case capacity
    ``resolved_db_capacity(max_iter)`` from the first trip. A lane that has
    run ``t`` iterations holds at most ``resolved_db_capacity(max_iter=t)``
    rows, so the early trips can run at that capacity exactly (rows are
    append-only and row indices stable under end-padding). The runner goes
    through a static ``schedule`` of cumulative iteration bounds: each stage
    runs at most its bound's trips at its capacity, the buffers are
    zero-row padded between stages, and a last stage runs every lane to
    completion at the full capacity.

    Results equal :func:`multistart_optimize` lane by lane: integers
    exactly; floats too while every stage runs at the full width, and up to
    the reassociation of another batch width where ``widths`` compact.

    ``schedule``: increasing cumulative iteration bounds strictly below
    ``max_iter`` (default ``max_iter/16, /8, /4, /2``). Stages whose
    capacities equal the next stage's are merged away.

    ``fleet``: skip the per-trip lane select for the append-only database
    and trajectory buffers (``_fleet_splice_big_buffers``). ``None``
    (default) enables it where :func:`fleet_eligible`; ``True`` raises on
    a config that is not. With it, the dead rows (row >= count) of the
    returned buffers hold junk: compare states after
    :func:`canonicalize_buffer_tails`.

    ``widths``: per-stage lane widths (lane compaction). Before a stage of
    width ``w < B`` the lanes are stably sorted active-first on the device
    and the stage runs on the first ``w`` only; lanes a narrow width left
    behind rejoin the sort at the next boundary, and the full-width
    to-completion stage at the end finishes any lane still running, so any
    widths give the same per-lane results. One entry per bounded stage, or
    one more that compacts the to-completion stage before the full-width
    catch-all. Entries ``>= B`` run the stage at full width. Lane order is
    restored once at the end.

    The result's ``trips`` counts the trips of every stage; ``stage_trips``
    holds them per stage, the to-completion stages last.
    """

    def __init__(self, mop, algo_config: Optional[AlgorithmConfig] = None,
                 dtype=torch.float32, schedule: Optional[tuple] = None,
                 fleet: Optional[bool] = None, widths: Optional[tuple] = None,
                 device=None, mesh=None):
        ac = algo_config or AlgorithmConfig()
        self.mesh = None if mesh is None else mesh_devices(mesh)
        if self.mesh is not None:
            device = self.mesh[0]
        if fleet is None:
            fleet = fleet_eligible(ac)
        elif fleet and not fleet_eligible(ac):
            raise ValueError("fleet=True requires use_db=True and "
                             "var_scaler_update != 'model' (append-only invariant)")
        self.solver = build_solver(mop, ac, dtype, device)
        self.dtype = dtype
        self.fleet = bool(fleet)
        max_iter = self.solver.ac.max_iter
        if schedule is None:
            schedule = tuple(sorted({max(1, max_iter // d) for d in (16, 8, 4, 2)}))
        schedule = tuple(int(t) for t in schedule if 0 < int(t) < max_iter)
        # merge stages that would run at the same capacities
        caps = [(_cap_at(self.solver, t), _traj_cap_at(self.solver, t)) for t in schedule]
        full = (self.solver.db_capacity, self.solver.T)
        keep = []
        for i, (t, c) in enumerate(zip(schedule, caps)):
            nxt = caps[i + 1] if i + 1 < len(caps) else full
            if c[0] < nxt[0] or c[1] < nxt[1]:
                keep.append((t, c))
        self.schedule = tuple(keep)
        if widths is not None:
            widths = tuple(int(w) for w in widths)
            if len(widths) not in (len(self.schedule), len(self.schedule) + 1):
                raise ValueError(
                    f"widths must have one entry per bounded stage "
                    f"({len(self.schedule)} after merging; schedule="
                    f"{tuple(t for t, _ in self.schedule)}), optionally "
                    f"plus one for a compacted to-completion stage")
            if any(w < 1 for w in widths):
                raise ValueError("widths entries must be >= 1")
        self.widths = widths
        self._shard_runners = None
        if self.mesh is not None:
            # one runner a device; with widths, each shard compacts its own
            # lanes to ceil(width / shards) (JAX's shard_map branch)
            n_sh = len(self.mesh)
            local = (None if widths is None
                     else tuple(max(1, -(-w // n_sh)) for w in widths))
            sched = tuple(t for t, _ in self.schedule)
            self._shard_runners = {
                d: StagedMultistart(self.solver.mop, ac, dtype, sched, self.fleet, local,
                                    device=d) for d in dict.fromkeys(self.mesh)}

    def __call__(self, x0_batch) -> OptimizeResult:
        if self.mesh is None:
            return self.solve_from_state(self.solver.initialize(x0_batch))
        x0 = torch.as_tensor(x0_batch)
        return on_mesh(self.mesh, x0.shape[0],
                       lambda d, lo, hi: self._shard_runners[d](x0[lo:hi]))

    @_full_precision_matmuls()
    def solve_from_state(self, states) -> OptimizeResult:
        """The stages from an initial batched state (``Solver.initialize``,
        or one carried over with ``utils/carry.state_from_numpy``); with a
        mesh, each shard of its lanes on its device."""
        if self.mesh is not None:
            return on_mesh(self.mesh, states.x.shape[0],
                           lambda d, lo, hi: self._shard_runners[d].solve_from_state(
                               tree_map(lambda t: t[lo:hi].to(d), states)))
        solver = self.solver
        B = states.x.shape[0]
        widths = self.widths
        order = None            # composed lane permutation: states[i] = orig[order[i]]
        stage_trips = []

        prev = 0
        for i, (t, (cap, tcap)) in enumerate(self.schedule):
            states = _resize_traj(_resize_dbs(states, cap), tcap)
            w = B if widths is None else min(widths[i], B)
            states, order, trips = _run_stage(solver, states, order, w, t - prev,
                                              self.fleet)
            stage_trips.append(trips)
            prev = t
        states = _resize_traj(_resize_dbs(states, solver.db_capacity), solver.T)
        if widths is not None and len(widths) == len(self.schedule) + 1 \
                and widths[-1] < B:
            states, order, trips = _run_stage(solver, states, order, widths[-1], None,
                                              self.fleet)
            stage_trips.append(trips)
        # full-width catch-all: no trip unless a width starved a lane
        states, trips = _run_bounded(solver, states, None, self.fleet)
        stage_trips.append(trips)
        if order is not None:
            inv = torch.argsort(order, stable=True)
            states = tree_map(lambda a: a[inv], states)
        return OptimizeResult(
            x=states.x, fx=states.fx, stop_code=states.stop_code,
            n_iterations=states.iter_counter - 1,
            n_evals=solver._total_evals(states.groups), state=states,
            trips=sum(stage_trips), stage_trips=tuple(stage_trips))

    def tuned(self, n_iterations, n_stages: int = 5, quantum: int = 32,
              slack: float = 1.1, db_capacity: Optional[int] = None) -> "StagedMultistart":
        """A compaction-tuned copy of this runner from a probe's per-lane
        iteration counts (:func:`suggest_schedule` and
        :func:`suggest_widths`)::

            probe = StagedMultistart(mop, ac)
            res = probe(x0)
            runner = probe.tuned(res.n_iterations,
                                 db_capacity=suggest_db_capacity(res))

        ``db_capacity`` (usually :func:`suggest_db_capacity` of the probe)
        sizes the databases at the probe's fill instead of the worst case.
        The results are the probe's as long as no lane overflows: check
        :func:`capacity_overflowed` on each result and rerun at the default
        capacity when it fires. Dtype and device carry over."""
        cmop, ac = self.solver.mop, self.solver.ac
        if db_capacity is not None:
            ac = dataclasses.replace(ac, db_capacity=int(db_capacity))
        dev = self.solver.device
        sched = suggest_schedule(n_iterations, ac.max_iter, n_stages)
        tmp = StagedMultistart(cmop, ac, self.dtype, schedule=sched, device=dev)
        ws = suggest_widths(tmp, n_iterations, slack=slack, quantum=quantum)
        return StagedMultistart(cmop, ac, self.dtype, schedule=sched, widths=ws,
                                device=dev, mesh=self.mesh)


# ---------------------------------------------------------- compacted runner

class CompactedMultistart:
    """Straggler-free multistart: stages of a bounded number of trips, and
    between them lane compaction into the buckets of a ladder.

    A plain batched solve runs every trip at the full batch until its
    slowest lane stops, while most lanes stop early. This runner runs
    ``stage_iters`` trips a stage and, between stages, stably sorts the
    lanes active-first on the device (:func:`_compact`) so that the next
    stage runs on the smallest ``bucket_ladder`` entry that holds every
    lane still running; finished lanes fill the bucket up and are frozen
    by the runner's lane select. Once the bucket is the ladder's smallest
    entry, the next stage runs to completion. Only the stop codes cross to
    the host between stages. Lane order is restored once at the end.

    ``bucket_ladder``: the allowed batch widths (default ``B >> s`` for
    ``s < 5``), sorted descending and led by ``B``. ``stage_schedule``:
    explicit trips of each stage (overrides ``stage_iters``); once it is
    exhausted, the next stage runs to completion. ``grow_db``: each stage
    runs at the database capacity its cumulative trip bound implies
    (:func:`_cap_at`), grown by zero rows between stages; the result
    carries the full capacity.

    Results equal :func:`multistart_optimize` lane by lane (integers
    exactly, floats up to the reassociation of another batch width); the
    result's ``trips`` counts the trips of every stage and
    ``stage_trips`` holds them per stage.
    """

    def __init__(self, mop, algo_config: Optional[AlgorithmConfig] = None,
                 dtype=torch.float32, stage_iters: int = 10,
                 bucket_ladder: Optional[tuple] = None,
                 stage_schedule: Optional[tuple] = None, grow_db: bool = True,
                 device=None):
        self.solver = build_solver(mop, algo_config, dtype, device)
        self.dtype = dtype
        self.stage_iters = int(stage_iters) if stage_iters is not None else 10
        self.bucket_ladder = bucket_ladder
        self.stage_schedule = (tuple(int(k) for k in stage_schedule)
                               if stage_schedule is not None else None)
        self.grow_db = bool(grow_db)

    def _cap_at(self, cum_iters: int) -> int:
        if not self.grow_db:
            return self.solver.db_capacity
        return _cap_at(self.solver, cum_iters)

    @_full_precision_matmuls()
    def __call__(self, x0_batch) -> OptimizeResult:
        solver = self.solver
        states = solver.initialize(x0_batch)
        B = states.x.shape[0]
        max_iter = solver.ac.max_iter
        ladder = self.bucket_ladder
        if ladder is None:
            ladder = tuple(max(1, B >> s) for s in range(5))
        ladder = sorted({int(b) for b in ladder if b <= B}, reverse=True)
        if not ladder or ladder[0] != B:
            ladder = [B] + [b for b in ladder if b < B]
        schedule = self.stage_schedule
        n_stages_max = (len(schedule) + 1 if schedule is not None else
                        (max_iter + 2 + self.stage_iters - 1) // self.stage_iters + 1)
        order = None            # composed lane permutation: states[i] = orig[order[i]]
        bucket, cum_iters, stage_trips = B, 0, []
        for i_stage in range(n_stages_max):
            if schedule is not None:
                k = schedule[i_stage] if i_stage < len(schedule) else max_iter + 2
            else:
                k = self.stage_iters if bucket > ladder[-1] else max_iter + 2
            cum_iters = min(cum_iters + k, max_iter + 2)
            states = _resize_dbs(states, self._cap_at(cum_iters))
            states, order, trips = _run_stage(solver, states, order, bucket, k,
                                              fleet=False)
            stage_trips.append(trips)
            if k > max_iter:
                break
            n_active = int(np.count_nonzero(
                states.stop_code.cpu().numpy() == int(STOP_CODE.CONTINUE)))
            if n_active == 0:
                break
            bucket = next((b for b in reversed(ladder) if b >= n_active), ladder[0])
        states = _resize_dbs(states, solver.db_capacity)
        if order is not None:
            inv = torch.argsort(order, stable=True)
            states = tree_map(lambda a: a[inv], states)
        return OptimizeResult(
            x=states.x, fx=states.fx, stop_code=states.stop_code,
            n_iterations=states.iter_counter - 1,
            n_evals=solver._total_evals(states.groups), state=states,
            trips=sum(stage_trips), stage_trips=tuple(stage_trips))


def compacted_multistart(mop, x0_batch, algo_config: Optional[AlgorithmConfig] = None,
                         dtype=torch.float32, stage_iters: int = 10,
                         bucket_ladder: Optional[tuple] = None,
                         stage_schedule: Optional[tuple] = None,
                         device=None) -> OptimizeResult:
    """One-shot :class:`CompactedMultistart` (build the runner once to run
    several batches)."""
    return CompactedMultistart(mop, algo_config, dtype, stage_iters=stage_iters,
                               bucket_ladder=bucket_ladder, stage_schedule=stage_schedule,
                               device=device)(x0_batch)


# ---------------------------------------------------------------- probe helpers

def _host(a) -> np.ndarray:
    """A tensor or array-like as a numpy array on the host."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def suggest_db_capacity(result, margin: float = 1.25, quantum: int = 32) -> int:
    """Probe-derived database capacity: the largest fill over lanes and
    groups of a probe run, times ``margin``, rounded up to ``quantum`` rows.

    Capacity never enters the numerics: an undersized run drops inserts and
    raises the sticky per-lane ``db.overflow`` flag. The flag, not the
    margin, is the guarantee: check :func:`capacity_overflowed` on every
    result and rerun at the default capacity when it fires."""
    counts = [int(np.max(_host(g.db.count))) for g in result.state.groups]
    q = max(1, int(quantum))
    need = int(np.ceil(max(counts) * float(margin) / q)) * q
    return max(q, need)


def capacity_overflowed(result) -> bool:
    """True if any group database of any lane dropped an insert (the sticky
    overflow flag): the guard of a :func:`suggest_db_capacity` run."""
    return any(bool(np.any(_host(g.db.overflow))) for g in result.state.groups)


def suggest_widths(runner: StagedMultistart, n_iterations, slack: float = 1.1,
                   quantum: int = 64, batch: Optional[int] = None) -> tuple:
    """Per-stage lane widths from a probe's per-lane iteration counts: the
    stage entered after bound ``t`` gets the count of lanes with
    ``n_iterations > t``, times ``slack`` (criticality micro-steps take
    trips without advancing the counter), rounded up to ``quantum`` lanes;
    the first stage takes every lane. One entry more than the runner's
    schedule: the last compacts the to-completion stage. Any widths are
    exact; only the time varies."""
    n_iter = _host(n_iterations)
    B = int(batch if batch is not None else n_iter.shape[0])
    q = max(1, int(quantum))

    def width(count):
        need = int(np.ceil(count * float(slack) / q)) * q
        return max(q, min(B, need))

    ws = [B]
    for t, _ in runner.schedule:
        ws.append(width(int((n_iter > t).sum())))
    return tuple(ws)


def suggest_schedule(n_iterations, max_iter: int, n_stages: int = 5) -> tuple:
    """Stage bounds at evenly spaced quantiles ``i / n_stages`` of a probe's
    per-lane iteration counts, plus one at the 99th percentile, deduplicated
    and strictly inside (0, max_iter). Any schedule is exact; only the time
    varies."""
    ni = _host(n_iterations)
    qs = [(i + 1) / n_stages for i in range(n_stages - 1)] + [0.99]
    bounds = sorted({int(np.quantile(ni, q)) for q in qs})
    return tuple(t for t in bounds if 0 < t < max_iter)


def staged_multistart(mop, x0_batch, algo_config: Optional[AlgorithmConfig] = None,
                      dtype=torch.float32, schedule: Optional[tuple] = None,
                      widths: Optional[tuple] = None, device=None,
                      mesh=None) -> OptimizeResult:
    """One-shot :class:`StagedMultistart` (build the runner once to run
    several batches); ``mesh`` as for the runner."""
    return StagedMultistart(mop, algo_config, dtype, schedule, widths=widths,
                            device=device, mesh=mesh)(x0_batch)
