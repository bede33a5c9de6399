"""Benchmark: 1024-way multistart RBF trust-region runs on one CUDA card.

The port's counterpart of ``bench.py``: the same problem (two parabolas in
2D, both objectives in one multiquadric RBF group, Halton starts), the same
budgets and the same protocol, run by :class:`StagedMultistart` at float32:

1. probe: the default staged runner on the starts;
2. ``suggest_db_capacity``, ``suggest_schedule`` and ``suggest_widths`` of
   the probe give the tuned runner;
3. a warm-up batch, one blocked-latency batch, then ``n_rep`` batches on
   distinct pre-staged starts back to back, with one final sync.

The headline runs ``max_iter=10, qp_iters=100``; ``ref_budget`` runs the
reference defaults ``max_iter=100, qp_iters=400``. ``vs_baseline`` divides
by the figures in ``baseline_measurement.json``, read as data: the JAX
package's single-instance float64 (``vs_baseline_f32``: float32) runs on
one CPU core, a measured stand-in for the single-core Julia reference, not
a TPU figure. ``capacity_overflow`` is the OR of the sticky database
overflow flag over every batch the point ran (probe, warm-up, blocked and
sustained batches), the guard of the probe-tightened capacity.

Prints one JSON line with ``bench.py``'s keys::

    python3 -m morbit_tpu_torch.bench [--device cuda|cpu] [--batch 1024] [--n-rep 8]

Runs on CUDA unless ``--device cpu`` is given; without a card the default
raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import torch

#: the headline budget and the reference defaults (``bench.py``)
HEADLINE = dict(max_iter=10, qp_iters=100)
REF_BUDGET = dict(max_iter=100, qp_iters=400)
LB, UB = [-4.0, -4.0], [4.0, 4.0]


def reference_runs_per_sec(key: str) -> tuple[float, float]:
    """(float64, float32) single-core CPU runs/s of ``baseline_measurement.json``;
    the float32 denominator is at least the float64 one (``bench.py``)."""
    path = pathlib.Path(__file__).resolve().parent.parent / "baseline_measurement.json"
    meas = json.loads(path.read_text())
    f64 = float(meas[key]["runs_per_sec"])
    f32 = float(meas.get(key + "_f32", meas[key])["runs_per_sec"])
    return f64, max(f32, f64)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tuned_runner(mop, ac, dtype, device, x0):
    """The probe protocol: the default staged runner on ``x0``, then the
    runner tuned from it. Returns (runner, probe result, its config)."""
    from morbit_tpu_torch.parallel.multistart import (StagedMultistart,
                                                      suggest_db_capacity,
                                                      suggest_schedule,
                                                      suggest_widths)

    probe = StagedMultistart(mop, ac, dtype, device=device)(x0)
    # the final fill bounds a run's fill only while rows are append-only:
    # under use_db=False each iteration empties the databases, so they keep
    # their fixed working-set capacity
    ac_tuned = (dataclasses.replace(ac, db_capacity=suggest_db_capacity(probe))
                if ac.use_db else ac)
    schedule = suggest_schedule(probe.n_iterations, ac.max_iter)
    tmp = StagedMultistart(mop, ac_tuned, dtype, schedule=schedule, device=device)
    widths = suggest_widths(tmp, probe.n_iterations, quantum=32)
    runner = StagedMultistart(mop, ac_tuned, dtype, schedule=schedule,
                              widths=widths, device=device)
    return runner, probe


def run_point(budget: dict, batch: int, n_rep: int, dtype, device) -> dict:
    """One bench point: the probe protocol, a warm-up, one blocked batch and
    ``n_rep`` sustained batches. ``setup_s`` spans the probe, the tuning and
    the warm-up (and the kernels' builds, on the first point of a process);
    ``batches`` holds every result in the order run, the probe first."""
    from morbit_tpu_torch import AlgorithmConfig
    from morbit_tpu_torch.models.configs import RbfConfig
    from morbit_tpu_torch.parallel.multistart import capacity_overflowed
    from morbit_tpu_torch.problems.synthetic import halton_starts, make_two_parabolas

    mop = make_two_parabolas(RbfConfig(kernel="multiquadric"), LB, UB)
    ac = AlgorithmConfig(**budget)
    x0 = torch.as_tensor(halton_starts(batch, LB, UB), dtype=dtype, device=device)

    t0 = time.perf_counter()
    runner, probe = tuned_runner(mop, ac, dtype, device, x0)
    warm = runner(x0)
    _sync(device)
    setup_s = time.perf_counter() - t0

    x0s = [x0 + torch.as_tensor(1e-5 * (i + 1), dtype=dtype) for i in range(n_rep)]
    _sync(device)
    t0 = time.perf_counter()
    blocked = runner(x0s[0])
    _sync(device)
    blocked_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    outs = [runner(xi) for xi in x0s]
    _sync(device)
    dt = (time.perf_counter() - t0) / n_rep

    batches = [probe, warm, blocked, *outs]
    return dict(runs_per_sec=batch / dt, blocked_latency_s=blocked_s,
                setup_s=setup_s, runner=runner, batches=batches,
                overflow=any(capacity_overflowed(r) for r in batches))


def main(argv=None) -> int:
    args = argparse.ArgumentParser()
    args.add_argument("--device", default=None)
    args.add_argument("--batch", type=int, default=1024)
    args.add_argument("--n-rep", type=int, default=8)
    a = args.parse_args(argv)
    from morbit_tpu_torch.core.algorithm import resolve_device

    device = resolve_device(a.device)
    dtype = torch.float32
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    head = run_point(HEADLINE, a.batch, a.n_rep, dtype, device)
    ref = run_point(REF_BUDGET, a.batch, max(1, a.n_rep // 2), dtype, device)
    f64, f32 = reference_runs_per_sec("bench_config")
    rf64, rf32 = reference_runs_per_sec("reference_default_config")
    rps, rrps = head["runs_per_sec"], ref["runs_per_sec"]
    tuned = ref["runner"]
    print(json.dumps({
        "metric": f"multistart RBF trust-region optimize() throughput "
                  f"({a.batch}-way batch, 2D two-parabolas, multiquadric, "
                  f"max_iter={HEADLINE['max_iter']}, {kind})",
        "value": rps,
        "unit": "runs/s",
        "vs_baseline": rps / f64,
        "vs_baseline_f32": rps / f32,
        "blocked_latency_ms": head["blocked_latency_s"] * 1e3,
        "db_capacity": head["runner"].solver.db_capacity,
        "capacity_overflow": head["overflow"],
        "protocol": f"sustained: {a.n_rep} back-to-back batches, distinct "
                    "pre-staged inputs, one final sync",
        "ref_budget": {
            "config": f"max_iter={REF_BUDGET['max_iter']}, qp_iters="
                      f"{REF_BUDGET['qp_iters']} (reference defaults), "
                      f"{a.batch}-way, probe-tuned StagedMultistart "
                      f"schedule={tuple(t for t, _ in tuned.schedule)} "
                      f"widths={tuned.widths} db_capacity={tuned.solver.db_capacity}",
            "runs_per_sec": rrps,
            "vs_baseline": rrps / rf64,
            "vs_baseline_f32": rrps / rf32,
            "compile_plus_probe_s": ref["setup_s"],
            "capacity_overflow": ref["overflow"],
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
