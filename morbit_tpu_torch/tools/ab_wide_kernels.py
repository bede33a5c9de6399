"""K1-K5 of two checkouts on one card, at the wide path's shapes.

Times K1 (``admm_stages_cuda``) at (nv, m) = (21, 42), 4 stages of 100
steps, K2 (``selection_cuda``) at n=20 with 5,332 and 1,200 rows, K3
(``round4_cuda``) at (max_points, pd, C) = (231, 21, 2310) with candidates
below a fill of at most 300 rows, and K4 (``rbf_gram_cuda``, cubic) at
(P, n) = (251, 20), on seeded random inputs (``chip_smoke.random_qps``,
``selection_case``, ``round4_case``, ``gram_case``), float32, B=1024, with
CUDA events; and K5 (``admm_iterations_cuda``, no caller) at (n, m) =
(3, 6) and (21, 42), 100 steps, float32 and float64, B=1024, on
``chip_smoke.admm_iterations_case``. It prints a SHA-256 of K3's outputs
(``accepted``, N), of K4's Gram bytes and of K5's (z, zz, y), so that the
lines of the two checkouts show whether their kernels agree to the bit,
and of K1's fixed-trip (z, zz, y) at (21, 42) float32 and at (3, 6)
float32 and float64 (``K1_nv21_m42_sha256``, ``K1_nv3_m6_f32_sha256``,
``K1_nv3_m6_f64_sha256``).
K4 is timed over ten launches back to back and K5 over five (their
wrappers' host time exceeds or nears the kernels'). ``--inputs`` also times K3
on the wide path's recorded inputs (``round4_phases --record``). With
``--wide-batch`` it also times one batch of the wide path (``chip_smoke.py``'s first ``wide_main_path`` batch:
ZDT1 at n=20, cubic RBF, the reference grid budget, 1024 Halton starts,
float32) on the host clock, its kernels built beforehand. With ``--paths``
it also prints a SHA-256 of the final state of one float32 batch of the
main path, the n=20 path and the n=50 path (``path_hashes``). Each checkout
runs in its own process (its own package and kernels), in turns parent,
change, change, parent; one JSON line each::

    python3 -m morbit_tpu_torch.tools.ab_wide_kernels --parent PATH [--change PATH] [--wide-batch] [--paths] [--inputs NPZ]

``PATH`` is the root of a checkout (``git archive`` of the parent commit
unpacked into a directory that ``.gitignore`` lists). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def _event_ms(fn, reps, inner=1):
    """Median CUDA-event time of ``fn()`` over ``reps`` timings (after one
    warm-up), each spanning ``inner`` calls back to back; the same method
    in both checkouts."""
    import statistics

    import torch

    fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def time_here(wide_batch: bool, inputs, paths: bool = False) -> dict:
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
    out = {"K1_nv21_m42_ms": _event_ms(
        lambda: qp_lane.admm_stages_cuda(P, q, A, lo, hi, rho0, **kw), 10)}
    digest = lambda *ts: hashlib.sha256(b"".join(
        t.contiguous().cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]
    out["K1_nv21_m42_sha256"] = digest(*qp_lane.admm_stages_cuda(P, q, A, lo, hi, rho0, **kw))
    for tag, k1_dt in (("f32", torch.float32), ("f64", torch.float64)):
        P3, q3, A3, lo3, hi3 = (torch.as_tensor(a, dtype=k1_dt, device="cuda")
                                for a in cs.random_qps(1024, 3, 6, 0))
        r3 = A3.abs().amax(-1)
        A3, lo3, hi3 = (A3 / r3[..., None]).contiguous(), lo3 / r3, hi3 / r3
        kw3 = dict(kw, sigma=1e-4 if tag == "f32" else 1e-6,
                   rho_lo=1e-3 if tag == "f32" else 1e-6, rho_hi=1e4 if tag == "f32" else 1e6)
        out[f"K1_nv3_m6_{tag}_sha256"] = digest(*qp_lane.admm_stages_cuda(
            P3, q3, A3, lo3, hi3, _rho_vec(lo3, hi3, 0.1), **kw3))
    for cap in (5332, 1200):
        args = cs._selection_tensors(cs.selection_case(
            np.random.default_rng(20 + cap), 1024, cap, 20, "mixed"), dt)
        out[f"K2_n20_cap{cap}_ms"] = _event_ms(
            lambda: prepare_fused.selection_cuda(*args, **cs.SEL_STATICS), 5)

    from morbit_tpu_torch.ops import dense_kernels

    X, cand, init, count, _ = cs.round4_case(np.random.default_rng(11), 1024, 2310, 20,
                                             231, 0.4, 251)
    cand &= np.arange(2310)[None, :] < np.random.default_rng(12).integers(21, 300, 1024)[:, None]
    f = lambda a: torch.as_tensor(a, dtype=dt, device="cuda")
    r4 = (f(X), torch.as_tensor(cand, device="cuda"), f(init),
          torch.as_tensor(count, dtype=torch.int32, device="cuda"))
    r4_kw = dict(kernel="cubic", param=3, poly_deg=1, max_points=231, chol_pivot=1e-14)
    out["K3_wide_ms"] = _event_ms(lambda: prepare_fused.round4_cuda(*r4, **r4_kw), 5)
    out["K3_wide_sha256"] = digest(*prepare_fused.round4_cuda(*r4, **r4_kw))
    if inputs:
        # the inputs the wide path gave K3 (``round4_phases --record``)
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "round4_phases", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                          "round4_phases.py"))
        rp = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(rp)
        for name, args, kw in rp.load_round4(inputs, dt):
            out[f"K3_{name}_ms"] = _event_ms(lambda: prepare_fused.round4_cuda(*args, **kw), 5)
            out[f"K3_{name}_sha256"] = digest(*prepare_fused.round4_cuda(*args, **kw))
    sites, mask, _ = cs.gram_case(np.random.default_rng(271), 1024, 251, 20)
    g = (f(sites), torch.as_tensor(mask, device="cuda"), "cubic", 3.0)
    out["K4_P251_n20_ms"] = _event_ms(lambda: dense_kernels.rbf_gram_cuda(*g), 10, inner=10)
    out["K4_P251_n20_sha256"] = digest(dense_kernels.rbf_gram_cuda(*g))
    k5_kw = dict(iters=100, sigma=1e-6, alpha=1.6)
    for tag, k5_dt in (("f32", torch.float32), ("f64", torch.float64)):
        for n, m in ((3, 6), (21, 42)):
            k5 = [torch.as_tensor(a, dtype=k5_dt, device="cuda")
                  for a in cs.admm_iterations_case(1024, n, m, seed=n)]
            out[f"K5_n{n}_m{m}_{tag}_ms"] = _event_ms(
                lambda: dense_kernels.admm_iterations_cuda(*k5, **k5_kw), 10, inner=5)
            out[f"K5_n{n}_m{m}_{tag}_sha256"] = digest(
                *dense_kernels.admm_iterations_cuda(*k5, **k5_kw))
    if wide_batch:
        import time

        from morbit_tpu_torch import AlgorithmConfig, multistart_optimize
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
    if paths:
        out.update(path_hashes(cs))
    return out


def path_hashes(cs) -> dict:
    """A SHA-256 of the final state of one float32 batch of each path whose
    bits a change to the float64 solves must leave as they are: the main
    path (two parabolas, one multiquadric group, 1024 Halton starts, the
    reference budget), the n=20 path at ``WIDE_SMOKE_BUDGET`` and the n=50
    path at ``WIDE50_BUDGET`` (1024 starts each), by the plain runner."""
    import numpy as np
    import torch

    from morbit_tpu_torch import AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.problems.synthetic import halton_starts
    from morbit_tpu_torch.utils.carry import state_to_numpy

    runs = {"main": (cs.rbf_mop(), cs.LB, cs.UB,
                     dict(max_iter=100, qp_iters=cs.QP_ITERS)),
            "n20": (cs.wide_mop(), None, None, cs.WIDE_SMOKE_BUDGET),
            "n50": (cs.wide_mop(cs.N_WIDE50), None, None, cs.WIDE50_BUDGET)}
    out = {}
    for name, (mop, lb, ub, budget) in runs.items():
        lb = mop.lb if lb is None else lb
        ub = mop.ub if ub is None else ub
        x0 = torch.as_tensor(halton_starts(1024, lb, ub, 1), dtype=torch.float32,
                             device="cuda")
        leaves = state_to_numpy(multistart_optimize(mop, x0, AlgorithmConfig(**budget),
                                                    dtype=torch.float32).state)
        out[f"{name}_f32_state_sha256"] = hashlib.sha256(b"".join(
            np.ascontiguousarray(leaves[k]).tobytes() for k in sorted(leaves))).hexdigest()[:16]
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", default=".")
    ap.add_argument("--wide-batch", action="store_true")
    ap.add_argument("--inputs", help="recorded K3 inputs of the wide path "
                    "(morbit_tpu_torch.tools.round4_phases --record) to time too")
    ap.add_argument("--paths", action="store_true",
                    help="also hash one float32 batch of the main, n=20 and n=50 paths")
    ap.add_argument("--here", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.here:
        print(json.dumps(time_here(args.wide_batch, args.inputs, args.paths)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    me = os.path.abspath(__file__)
    for name in ("parent", "change", "change", "parent"):
        root = os.path.abspath(getattr(args, name))
        run = subprocess.run([sys.executable, me, "--here", "--parent", root]
                             + ["--wide-batch"] * args.wide_batch + ["--paths"] * args.paths
                             + (["--inputs", os.path.abspath(args.inputs)]
                                if args.inputs else []),
                             cwd=root, capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-3000:], file=sys.stderr)
            return run.returncode
        timings = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": name, "root": root, **timings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
