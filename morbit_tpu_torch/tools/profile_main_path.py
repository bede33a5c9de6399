"""Where one main-path batch spends its time on the card.

Runs ``multistart_optimize`` on 1024 Halton starts at float32 once to warm
up, then once under ``torch.profiler``, and prints one JSON line: wall
time, outer trips, device kernels launched, summed device kernel time and
its share of the wall time (the device busy share), the device time of
the port's own kernels (K1 ``qp_admm``, K2 ``rbf_selection``, K3
``rbf_round4``, K4 ``rbf_gram``), the device kernels with the most device
time and the operators with the most host time. The models:

* ``rbf`` (default): two parabolas, both objectives in one multiquadric RBF
  group, ``max_iter=100, qp_iters=400`` (the ``chip_smoke.py`` main path);
* ``exact``: the same with exact objectives;
* ``zdt20``: the wide-n path, ZDT1 at n=20 with both objectives in one
  cubic RBF group at the reference grid budget (``chip_smoke.py``
  ``wide_main_path``). Its batch runs ~200 trips of ~16,000 launches each,
  too many events for one trace, so the profile covers trips 10-14, and
  the wall time and busy share are those of that window;
* ``staged``: the ``rbf`` model run by the probe-tuned ``StagedMultistart``
  (the bench twin's protocol, ``morbit_tpu_torch/bench.py``). The line adds
  the trips of each stage and the device kernels of one stage boundary at
  full width, profiled alone: the capacity resizes, the active-first sort,
  the gathers and the split of the state, and the rejoin;
* ``constrained``: the ``rbf`` model under the constrained configuration
  (``make_constrained_two_parabolas``: ``x1 + x2 <= 1`` and the exact ball
  ``||x||^2 <= 2.25``), run by the plain runner; the line adds the
  restoration loop's iterations;
* ``taylor``, ``lagrange``, ``ps``: the two parabolas with a degree-2
  finite-difference Taylor group, a degree-2 Lagrange group, or the
  ``rbf`` group with Pascoletti-Serafini descent (``chip_smoke.py``
  ``taylor_main_path`` and its siblings), run by the plain runner. A
  Lagrange trip launches ~25,000 kernels, so that profile covers trips 1-5,
  as ``zdt20``'s covers 10-14; the line adds the ascent steps;
* ``composite``: ``examples/composites.py``'s problem
  (``make_composite``: one cubic RBF group models g, the composite
  objectives g0 and g1 + 0.1 x0 and the composite constraint g0 - 9 <= 0),
  ``scaler_model``: the ``rbf`` model with ``var_scaler_update='model'``,
  ``no_db``: the ``rbf`` model with ``use_db=False`` (``chip_smoke.py``
  ``composite_main_path`` and its siblings), each run by the plain runner;
* ``host``: the ``rbf`` model with both objectives as NumPy functions on
  the host (``host=True, can_batch=True``), ``exit_eps``: the ``rbf`` model
  with ``qp_exit_eps=1e-5``, ``max_points``: the ``rbf`` model with
  ``use_max_points=True`` and ``use_db=False`` (``chip_smoke.py``
  ``host_main_path`` and its siblings), each run by the plain runner; the
  host line adds the host round trips and the seconds inside the user's
  functions;
* ``compacted``: the ``rbf`` model run by ``CompactedMultistart`` with its
  default ladder (B >> s for s < 5) and ``stage_iters=10`` (``chip_smoke.py``
  ``compacted_main_path``); the line adds the lanes and trips of each
  stage;
* ``parametric``: ``parametric_multistart`` on ``build_shifted`` (the two
  parabolas centred at +-theta, one multiquadric RBF group), each lane's
  theta drawn from ``numpy.random.default_rng(0)`` in [0.5, 2.5]^2
  (``chip_smoke.py`` ``parametric_main_path``).

    python3 -m morbit_tpu_torch.tools.profile_main_path [--model rbf|exact|zdt20|staged|constrained|taylor|lagrange|ps|composite|scaler_model|no_db|host|exit_eps|max_points|compacted|parametric]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch


def boundary_kernels(runner, x0) -> int:
    """Device kernels of one stage boundary of ``runner`` on the initial
    state of ``x0``, at full width: the resizes to the first stage's
    capacities, the active-first sort and split at half the lanes, the
    rejoin."""
    from torch.profiler import ProfilerActivity, profile

    from morbit_tpu_torch.parallel.multistart import (_compact, _rejoin, _resize_dbs,
                                                      _resize_traj)

    states = runner.solver.initialize(x0)
    cap, tcap = runner.schedule[0][1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        states = _resize_traj(_resize_dbs(states, cap), tcap)
        head, tail, _ = _compact(states, None, x0.shape[0] // 2)
        _rejoin(head, tail)
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


@contextlib.contextmanager
def stage_log(log):
    """Append (lanes, trips, lanes running at entry) of every stage a
    runner runs to ``log``."""
    from morbit_tpu_torch.core.enums import STOP_CODE
    from morbit_tpu_torch.parallel import multistart

    inner = multistart._run_bounded

    def wrapped(solver, states, k, fleet):
        running = int((states.stop_code == STOP_CODE.CONTINUE).sum())
        out = inner(solver, states, k, fleet)
        log.append((int(states.x.shape[0]), out[1], running))
        return out
    multistart._run_bounded = wrapped
    try:
        yield
    finally:
        multistart._run_bounded = inner


def main(argv=None) -> int:
    args = argparse.ArgumentParser()
    args.add_argument("--model", choices=("rbf", "exact", "zdt20", "staged", "constrained",
                                          "taylor", "lagrange", "ps", "composite",
                                          "scaler_model", "no_db", "host", "exit_eps",
                                          "max_points", "compacted", "parametric"),
                      default="rbf")
    model = args.parse_args(argv).model
    B, window = 1024, 5
    #: the trips a windowed profile skips before its window
    skip = {"zdt20": 10, "lagrange": 1}
    if not torch.cuda.is_available():
        print("profile_main_path: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from morbit_tpu_torch import MOP, AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.core.descent import PascolettiSerafiniConfig
    from morbit_tpu_torch.models.configs import LagrangeConfig, RbfConfig, TaylorConfig
    from morbit_tpu_torch.ops import boxopt
    from morbit_tpu_torch.problems.synthetic import (halton_starts, make_composite,
                                                     make_constrained_two_parabolas,
                                                     make_two_parabolas, make_zdt)

    if model == "zdt20":
        mop = make_zdt("zdt1", 20, model_cfg=RbfConfig(kernel="cubic"))
        ac = AlgorithmConfig(max_iter=100, max_evals=20000, delta_0=0.1, delta_max=0.5,
                             f_tol_rel=1e-3, x_tol_rel=1e-3, qp_iters=400)
    elif model == "composite":
        mop = make_composite(RbfConfig(kernel="cubic"))
        ac = AlgorithmConfig(max_iter=100, qp_iters=400)
    elif model == "host":
        mop = MOP([-4.0, -4.0], [4.0, 4.0])
        for c in (1.0, -1.0):
            mop.add_objective(lambda X, c=c: ((X - c) ** 2).sum(-1), host=True,
                              can_batch=True, model_cfg=RbfConfig(kernel="multiquadric"))
        ac = AlgorithmConfig(max_iter=100, qp_iters=400)
    else:
        cfg = {"exact": None, "taylor": TaylorConfig(degree=2, mode="fd"),
               "lagrange": LagrangeConfig(degree=2),
               "max_points": RbfConfig(kernel="multiquadric", use_max_points=True)}.get(
                   model, RbfConfig(kernel="multiquadric"))
        make = make_constrained_two_parabolas if model == "constrained" else make_two_parabolas
        mop = make(cfg, lb=[-4.0, -4.0], ub=[4.0, 4.0])
        ac = AlgorithmConfig(max_iter=100, qp_iters=400, descent_method=(
            PascolettiSerafiniConfig() if model == "ps" else "steepest_descent"),
            var_scaler_update="model" if model == "scaler_model" else "none",
            use_db=model not in ("no_db", "max_points"),
            qp_exit_eps=1e-5 if model == "exit_eps" else 0.0)
    starts = [torch.as_tensor(halton_starts(B, mop.lb, mop.ub, 1 + k * B),
                              dtype=torch.float32, device="cuda") for k in range(2)]
    extra = {}
    if model in skip:
        from morbit_tpu_torch import STOP_CODE
        from morbit_tpu_torch.parallel.multistart import build_solver
        from morbit_tpu_torch.utils.tree import tree_where

        solver = build_solver(mop, ac, torch.float32)
        state = solver.initialize(starts[0])

        def trip(state):   # one trip of Solver.solve_from_state
            running = state.stop_code == STOP_CODE.CONTINUE
            bool(running.any())
            return tree_where(running, solver.iterate(state), state)
        for _ in range(skip[model]):
            state = trip(state)
        torch.cuda.synchronize()
        boxopt.ascent_steps = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(window):
                state = trip(state)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        trips = window
    else:
        if model == "staged":
            from morbit_tpu_torch.bench import tuned_runner

            runner, _ = tuned_runner(mop, ac, torch.float32, torch.device("cuda"), starts[0])
            run = runner
            extra = dict(schedule=[t for t, _ in runner.schedule],
                         widths=list(runner.widths), db_capacity=runner.solver.db_capacity,
                         boundary_kernels=boundary_kernels(runner, starts[0]))
        elif model == "compacted":
            from morbit_tpu_torch import CompactedMultistart

            run = CompactedMultistart(mop, ac, torch.float32, stage_iters=10)
        elif model == "parametric":
            import numpy as np

            from morbit_tpu_torch import parametric_multistart
            from morbit_tpu_torch.problems.synthetic import build_shifted

            theta = np.random.default_rng(0).uniform(0.5, 2.5, (B, 2))
            run = lambda x: parametric_multistart(build_shifted, x, theta, ac, torch.float32)
        elif model in ("constrained", "composite"):
            from morbit_tpu_torch.parallel.multistart import build_solver

            solver = build_solver(mop, ac, torch.float32)
            run = solver.solve
        else:
            run = lambda x: multistart_optimize(mop, x, ac, dtype=torch.float32)
        run(starts[0])
        if model in ("constrained", "composite"):
            solver.restoration_iterations = 0
        for f in mop.functions:
            f.stats.reset()
        torch.cuda.synchronize()
        boxopt.ascent_steps = 0
        stages = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                stage_log(stages):
            t0 = time.perf_counter()
            res = run(starts[1])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        trips = res.trips
        extra["stage_trips"] = list(res.stage_trips)
        if model == "compacted":
            extra["stage_lanes"] = [w for w, *_ in stages]
        if model in ("constrained", "composite"):
            extra["restoration_iterations"] = solver.restoration_iterations
        if model == "host":
            st = mop.functions[0].stats
            extra.update(host_round_trips=st.round_trips, host_rows=st.rows["eval"],
                         host_user_s=sum(f.stats.seconds for f in mop.functions))

    extra["ascent_steps"] = boxopt.ascent_steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    own_ms = {name: sum(e.time_range.elapsed_us() for e in kernels
                        if name in e.name) / 1e3
              for name in ("qp_admm", "rbf_selection", "rbf_round4", "rbf_gram")}
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top_device = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    # the same total as the profiler's own per-operator attribution
    attributed_us = sum(a.self_device_time_total for a in prof.key_averages())
    top = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total,
                 reverse=True)[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "model": model, "B": B,
        "dtype": "float32",
        "wall_s": wall_s, "trips": trips, **extra,
        "device_kernels": len(kernels),
        "device_kernels_per_trip": len(kernels) / max(trips, 1),
        "device_kernel_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e6 / wall_s,
        "attributed_device_ms": attributed_us / 1e3,
        "kernel_device_ms": own_ms,
        "top_device_kernels": [{"name": k[:120], "device_ms": v / 1e3}
                               for k, v in top_device],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "top_host_ops": [{"name": a.key, "calls": a.count,
                          "self_cpu_ms": a.self_cpu_time_total / 1e3}
                         for a in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
