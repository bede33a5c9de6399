"""Where one lane of a float64 grid setting parts, card against CPU.

A setting of ``parallel/benchmarks.py`` (its problem, its defaults and its
Halton starts, as ``perform_test`` runs it) at float64, stepped trip by
trip on the card and on the CPU. One JSON line each:

* ``free``: both runs freely, the lane's largest float gap (leaf and both
  values) after each trip;
* ``lockstep``: from the CPU's state at each trip, the card's trip against
  the CPU's: the lane's largest float gap after that one trip;
* ``ops``: at each trip of ``--trips`` (default: the lockstep's widest),
  the calls of that trip op by op (``op_trace``): the first that parts,
  those that make a gap from equal inputs and those that grow one most;
* ``ulp``: the CPU run again from the lane's start moved by one ulp in
  each coordinate in turn, and the largest gap that makes at the end in
  x, fx and omega: how far the run itself carries a rounding.

    python3 -m morbit_tpu_torch.tools.card_cpu_gaps [--setting zdt1,5,rbf_cubic,steepest_descent,4] [--lane 1] [--parts free lockstep ops ulp] [--trips T ...]

Needs the card (``ulp`` alone runs on the CPU).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from morbit_tpu_torch.tools import op_trace


def _setup(setting, over):
    from morbit_tpu_torch.parallel.benchmarks import Setting, _default_config, make_problem
    from morbit_tpu_torch.problems.synthetic import halton_starts

    s = Setting(*setting)
    mop = lambda: make_problem(s.problem, s.n_vars, s.model)
    starts = halton_starts(s.n_starts, mop().lb, mop().ub)
    return s, mop, starts, _default_config(s, **over)


def _lane_gap(a, b, lane):
    """The lane's largest absolute float gap between two states, its leaf
    and both values."""
    from morbit_tpu_torch.utils.carry import state_to_numpy

    a, b = state_to_numpy(a), state_to_numpy(b)
    best = {"gap": 0.0}
    for name in a:
        x, y = a[name][lane], b[name][lane]
        if x.dtype.kind != "f":
            if not np.array_equal(x, y):
                best.setdefault("integers_apart", []).append(name)
            continue
        both = np.isfinite(x) & np.isfinite(y)
        d = np.where(both, np.abs(np.where(both, x, 0.0) - np.where(both, y, 0.0)), 0.0)
        if d.size and d.max() > best["gap"]:
            j = np.unravel_index(int(d.argmax()), d.shape)
            best.update(gap=float(d.max()), leaf=name, card=float(x[j]), cpu=float(y[j]))
    return best


def _step(solver, state):
    from morbit_tpu_torch import STOP_CODE
    from morbit_tpu_torch.utils.tree import tree_where

    running = state.stop_code == STOP_CODE.CONTINUE
    return tree_where(running, solver.iterate(state), state)


def _running(state):
    from morbit_tpu_torch import STOP_CODE

    return bool((state.stop_code == STOP_CODE.CONTINUE).any())


def free(solvers, starts, lane):
    card = solvers["cuda"].initialize(starts)
    cpu = solvers["cpu"].initialize(starts)
    rows = [{"trip": 0, **_lane_gap(card, cpu, lane)}]
    while _running(card) or _running(cpu):
        card, cpu = _step(solvers["cuda"], card), _step(solvers["cpu"], cpu)
        rows.append({"trip": len(rows), **_lane_gap(card, cpu, lane)})
    return rows


def lockstep(solvers, starts, lane):
    """The lane's one-trip gaps and the CPU's states, trip by trip."""
    from morbit_tpu_torch.utils.tree import tree_map

    cpu = solvers["cpu"].initialize(starts)
    rows, states = [], [cpu]
    while _running(cpu):
        card = _step(solvers["cuda"], tree_map(lambda t: t.to("cuda"), cpu))
        cpu = _step(solvers["cpu"], cpu)
        rows.append({"trip": len(rows) + 1, **_lane_gap(card, cpu, lane)})
        states.append(cpu)
    return rows, states


def ops(solvers, state, lane, width):
    """One trip from the CPU's ``state`` on both devices, call by call."""
    from morbit_tpu_torch.utils.tree import tree_map

    on_card_state = tree_map(lambda t: t.to("cuda"), state)
    with op_trace.tracing(width, lane) as on_card:
        _step(solvers["cuda"], on_card_state)
    with op_trace.tracing(width, lane) as on_cpu:
        _step(solvers["cpu"], state)
    return op_trace.summarize(op_trace.compare(on_card, on_cpu))


def ulp(mop, starts, ac, lane):
    """The CPU run from the lane's start moved one ulp up in each
    coordinate in turn: the largest final gap of the lane in x, fx and
    omega against the unmoved run."""
    from morbit_tpu_torch import multistart_optimize

    def final(x0):
        r = multistart_optimize(mop(), torch.as_tensor(x0), ac, torch.float64, device="cpu")
        traj = r.state.traj
        last = int(traj.count[lane]) - 1
        return {"x": r.x[lane].numpy(), "fx": r.fx[lane].numpy(),
                "omega": traj.omega[lane, last].numpy(),
                "ints": (int(r.n_iterations[lane]), int(r.stop_code[lane]))}

    ref = final(starts)
    out = []
    for j in range(starts.shape[1]):
        moved = starts.copy()
        moved[lane, j] = np.nextafter(moved[lane, j], np.inf)
        got = final(moved)
        out.append({"coordinate": j, "integers_equal": got["ints"] == ref["ints"],
                    **{k: float(np.max(np.abs(got[k] - ref[k]))) for k in ("x", "fx", "omega")}})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--setting", default="zdt1,5,rbf_cubic,steepest_descent,4")
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--qp-iters", type=int, default=None)
    p.add_argument("--lane", type=int, default=1)
    p.add_argument("--parts", nargs="*", default=["free", "lockstep", "ops", "ulp"])
    p.add_argument("--trips", type=int, nargs="*", default=None,
                   help="for the ops part: the trips to compare call by call")
    args = p.parse_args(argv)
    from morbit_tpu_torch.parallel.multistart import build_solver

    name, n, model, descent, starts = args.setting.split(",")
    over = {k: v for k, v in (("max_iter", args.max_iter), ("qp_iters", args.qp_iters))
            if v is not None}
    s, mop, starts, ac = _setup((name, int(n), model, descent, int(starts)), over)
    head = {"setting": s.key, "overrides": over, "lane": args.lane}
    if set(args.parts) - {"ulp"}:
        head["card"] = torch.cuda.get_device_name(0)
        solvers = {d: build_solver(mop(), ac, torch.float64, d) for d in ("cuda", "cpu")}
    if "free" in args.parts:
        print(json.dumps({"part": "free", **head, "trips": free(solvers, starts, args.lane)}),
              flush=True)
    if "lockstep" in args.parts or "ops" in args.parts:
        rows, states = lockstep(solvers, starts, args.lane)
        if "lockstep" in args.parts:
            print(json.dumps({"part": "lockstep", **head, "trips": rows}), flush=True)
        trips = args.trips
        if trips is None:
            trips = [max(rows, key=lambda r: r["gap"])["trip"]] if rows else []
        for t in (t for t in trips if 1 <= t <= len(rows)) if "ops" in args.parts else ():
            print(json.dumps({"part": "ops", **head, "trip": t,
                              **ops(solvers, states[t - 1], args.lane, s.n_starts)}),
                  flush=True)
    if "ulp" in args.parts:
        print(json.dumps({"part": "ulp", **head, "moves": ulp(mop, starts, ac, args.lane)}),
              flush=True)


if __name__ == "__main__":
    main()
