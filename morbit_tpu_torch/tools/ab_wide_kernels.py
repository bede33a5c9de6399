"""K1 and K2 of two checkouts on one card, at the wide path's shapes.

Times K1 (``admm_stages_cuda``) at (nv, m) = (21, 42), 4 stages of 100
steps, and K2 (``selection_cuda``) at n=20 with 5,332 and 1,200 rows, on
seeded random inputs (``chip_smoke.random_qps``, ``chip_smoke.selection_case``),
float32, B=1024, with CUDA events. With ``--wide-batch`` it also times one
batch of the wide path (``chip_smoke.py``'s first ``wide_main_path`` batch:
ZDT1 at n=20, cubic RBF, the reference grid budget, 1024 Halton starts,
float32) on the host clock, its kernels built beforehand. Each checkout
runs in its own process (its own package and kernels), in turns parent,
change, change, parent; one JSON line each::

    python3 -m morbit_tpu_torch.tools.ab_wide_kernels --parent PATH [--change PATH] [--wide-batch]

``PATH`` is the root of a checkout (``git archive`` of the parent commit
unpacked into a directory that ``.gitignore`` lists). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def time_here(wide_batch: bool) -> dict:
    """The timings of the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from morbit_tpu_torch.ops import prepare_fused, qp_lane
    from morbit_tpu_torch.ops.qp import _rho_vec

    dt = torch.float32
    P, q, A, lo, hi = (torch.as_tensor(a, dtype=dt, device="cuda")
                       for a in cs.random_qps(1024, 21, 42, 2))
    r = A.abs().amax(-1)
    A, lo, hi = (A / r[..., None]).contiguous(), lo / r, hi / r
    kw = dict(n_stages=4, n_steps=100, sigma=1e-4, alpha=1.6, rho_lo=1e-3, rho_hi=1e4)
    rho0 = _rho_vec(lo, hi, 0.1)
    out = {"K1_nv21_m42_ms": cs.event_ms(
        lambda: qp_lane.admm_stages_cuda(P, q, A, lo, hi, rho0, **kw), 10)}
    for cap in (5332, 1200):
        args = cs._selection_tensors(cs.selection_case(
            np.random.default_rng(20 + cap), 1024, cap, 20, "mixed"), dt)
        out[f"K2_n20_cap{cap}_ms"] = cs.event_ms(
            lambda: prepare_fused.selection_cuda(*args, **cs.SEL_STATICS), 5)
    if wide_batch:
        import time

        from morbit_tpu_torch import AlgorithmConfig, multistart_optimize
        from morbit_tpu_torch.ops import dense_kernels
        from morbit_tpu_torch.problems.synthetic import halton_starts

        prepare_fused.build_round4()
        dense_kernels.build_gram()
        mop = cs.wide_mop()
        x0 = torch.as_tensor(halton_starts(1024, mop.lb, mop.ub, 1), dtype=dt, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = multistart_optimize(mop, x0, AlgorithmConfig(**cs.WIDE_BUDGET), dtype=dt)
        torch.cuda.synchronize()
        out.update(wide_batch_s=time.perf_counter() - t0, wide_trips=res.trips,
                   wide_mean_evals=float(res.n_evals.double().mean()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", default=".")
    ap.add_argument("--wide-batch", action="store_true")
    ap.add_argument("--here", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.here:
        print(json.dumps(time_here(args.wide_batch)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    me = os.path.abspath(__file__)
    for name in ("parent", "change", "change", "parent"):
        root = os.path.abspath(getattr(args, name))
        run = subprocess.run([sys.executable, me, "--here", "--parent", root]
                             + ["--wide-batch"] * args.wide_batch,
                             cwd=root, capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-3000:], file=sys.stderr)
            return run.returncode
        timings = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": name, "root": root, **timings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
