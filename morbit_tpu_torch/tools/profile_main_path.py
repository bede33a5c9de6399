"""Where one main-path batch spends its time on the card.

Runs ``multistart_optimize`` on 1024 two-parabolas Halton starts
(float32, ``max_iter=100, qp_iters=400``, the ``chip_smoke.py`` main path:
both objectives in one multiquadric RBF group, or with ``--model exact``
exact objectives) once to warm up, then once under ``torch.profiler`` and
prints one JSON line: wall time, outer trips, device kernels launched,
summed device kernel time and its share of the wall time (the device busy
share), the device time of the port's own kernels (K1 ``qp_admm``, K2
``rbf_selection``, K3 ``rbf_round4``), and the operators with the most
host time.

    python3 -m morbit_tpu_torch.tools.profile_main_path [--model rbf|exact]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    args = argparse.ArgumentParser()
    args.add_argument("--model", choices=("rbf", "exact"), default="rbf")
    model = args.parse_args(argv).model
    if not torch.cuda.is_available():
        print("profile_main_path: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from morbit_tpu_torch import AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.models.configs import RbfConfig
    from morbit_tpu_torch.problems.synthetic import halton_starts, make_two_parabolas

    lb, ub, B = [-4.0, -4.0], [4.0, 4.0], 1024
    cfg = RbfConfig(kernel="multiquadric") if model == "rbf" else None
    mop = make_two_parabolas(cfg, lb=lb, ub=ub)
    ac = AlgorithmConfig(max_iter=100, qp_iters=400)
    starts = [torch.as_tensor(halton_starts(B, lb, ub, 1 + k * B),
                              dtype=torch.float32, device="cuda") for k in range(2)]
    multistart_optimize(mop, starts[0], ac, dtype=torch.float32)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = multistart_optimize(mop, starts[1], ac, dtype=torch.float32)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    own_ms = {name: sum(e.time_range.elapsed_us() for e in kernels
                        if name in e.name) / 1e3
              for name in ("qp_admm", "rbf_selection", "rbf_round4")}
    # the same total as the profiler's own per-operator attribution
    attributed_us = sum(a.self_device_time_total for a in prof.key_averages())
    top = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total,
                 reverse=True)[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "model": model, "B": B,
        "dtype": "float32",
        "wall_s": wall_s, "trips": res.trips,
        "device_kernels": len(kernels),
        "device_kernels_per_trip": len(kernels) / max(res.trips, 1),
        "device_kernel_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e6 / wall_s,
        "attributed_device_ms": attributed_us / 1e3,
        "kernel_device_ms": own_ms,
        "top_host_ops": [{"name": a.key, "calls": a.count,
                          "self_cpu_ms": a.self_cpu_time_total / 1e3}
                         for a in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
