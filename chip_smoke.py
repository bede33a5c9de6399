"""Chip smoke test of the PyTorch/CUDA port (``morbit_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. ``build``       — nvcc-builds the ADMM kernel (``csrc/qp_admm.cu``).
2. ``kernel_admm`` — the kernel against its plain PyTorch twin on the card,
   B=1024 random QPs and two-parabolas / three-variable descent LPs,
   nv=3/m=6 and nv=4/m=8, qp_iters=400, float32 and float64: status_ok of
   ``solve_qp`` equal on every lane, the kernel's z within 1e-9 (float64)
   or 2e-3 (float32) of the twin's on the ok lanes.
3. ``card_vs_cpu`` — ``multistart_optimize`` at float64, 64 Halton starts,
   max_iter=100, on the card and on the CPU: integers equal, x/fx within 1e-9.
4. ``main_path``   — ``multistart_optimize`` at float32 on 1024 Halton starts
   of two parabolas, max_iter=100, qp_iters=400: the launch count, the
   outer-trip count, the Pareto-set fraction and the sustained rate.

Then the card's name and power limit, one JSON line with the kernel table,
and as the last line ``{"ok": true, "device": {...}}``. Without CUDA it
exits non-zero before printing any result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
B_MAIN = 1024
QP_ITERS, ADAPT_EVERY = 400, 100


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def event_ms(fn, reps):
    """Median of ``reps`` CUDA-event timings of ``fn()`` (after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def admm_flops(nv, m, n_stages, n_steps):
    """Arithmetic operations (each add, multiply, divide, sqrt, compare 1)
    of one lane of the fixed-trip ADMM, counted from the loops of
    ``csrc/qp_admm.cu`` (the jitter refactorization, taken only on
    breakdown, not included)."""
    tri = nv * (nv + 1) // 2
    form_m = tri * 3 * m + nv
    chol = sum(2 * j + 1 + (nv - 1 - j) * (2 * j + 1) for j in range(nv))
    linv = sum(1 + sum(1 + 2 * (i - j - 1) + 2 for i in range(j + 1, nv))
               for j in range(nv))
    minv = sum(2 * (nv - i) - 1 for i in range(nv) for _ in range(i + 1))
    stage_setup = form_m + chol + linv + minv + m
    step = (2 * m + nv * (2 + 2 * m) + nv * (2 * nv - 1) + 3 * nv
            + m * (2 * nv - 1 + 10))
    resid = (m * (2 * nv + 2) + nv * (2 * nv + 2 * m + 2) + 6 + 3 * m)
    return n_stages * (stage_setup + n_steps * step) + (n_stages - 1) * resid


def admm_bytes(nv, m, itemsize):
    """Bytes one lane must move: P, q, A, l, u, rho0 read, z, zz, y written."""
    return itemsize * (nv * nv + nv + m * nv + 3 * m + nv + 2 * m)


# ----------------------------------------------------------------- problems

def random_qps(B, n, m, seed):
    """Feasible bounded QPs in OSQP form (``tests/test_qp_lane.py`` pattern)."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n))
    P = 0.1 * G @ G.transpose(0, 2, 1) + 0.01 * np.eye(n)
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n))
    A[:, -n:] = np.eye(n)
    zstar = rng.uniform(-0.5, 0.5, size=(B, n))
    Az = np.einsum("bmn,bn->bm", A, zstar)
    slack = np.abs(rng.normal(size=(B, m))) + 0.3
    lo, hi = Az - slack, Az + slack
    lo[:, -n:], hi[:, -n:] = -1.0, 1.0
    lo[:, 0] = -np.inf
    lo[:, 1], hi[:, 1] = -np.inf, np.inf
    lo[:, 2] = hi[:, 2] = Az[:, 2]
    return P, q, A, lo, hi


def descent_lps(B, n):
    """Steepest-descent LPs of the solver at Halton starts: two parabolas
    on [-4, 4]^2 (n=2) or the three-variable oracle problem on [-2, 3]^3."""
    from morbit_tpu_torch.core.descent import descent_lp
    from morbit_tpu_torch.problems.synthetic import halton_starts

    if n == 2:
        lb, ub = np.full(2, -4.0), np.full(2, 4.0)
        x = halton_starts(B, lb, ub)
        J = np.stack([2.0 * (x - 1.0), 2.0 * (x + 1.0)], axis=1)
    else:
        lb, ub = np.full(3, -2.0), np.full(3, 3.0)
        x = halton_starts(B, lb, ub)
        x0, x1, x2 = x[:, 0], x[:, 1], x[:, 2]
        J = np.stack([
            np.stack([2.0 * (x0 - 1.0), 4.0 * x1, x2], axis=1),
            np.stack([2.0 * (x0 + 1.0) + 0.1 * x1,
                      2.0 * (x1 - 0.5) + 0.1 * x0, 2.0 * x2], axis=1)], axis=1)
    t = lambda a: torch.as_tensor(a)
    x_s = (x - lb) / (ub - lb)
    return [a.numpy() for a in descent_lp(t(x_s), t(J * (ub - lb)),
                                          t(np.zeros(n)), t(np.ones(n)))]


# ------------------------------------------------------------------- phases

def ptxas_summary(log):
    """Registers and spill bytes per kernel instance from ``-Xptxas=-v``
    output, keyed like ``f32_nv3_m6`` (``nv0_m0``: runtime sizes)."""
    out, key = {}, None
    for line in log.splitlines():
        hit = re.search(r"qp_admm_kernelI([fd])Li(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line and hit:
            key = f"{'f32' if hit[1] == 'f' else 'f64'}_nv{hit[2]}_m{hit[3]}"
        elif key and "spill stores" in line:
            out.setdefault(key, {})["spill_store_bytes"] = int(
                re.search(r"(\d+) bytes spill stores", line)[1])
        elif key and "Used" in line and "registers" in line:
            out.setdefault(key, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
    return out


def phase_build():
    from morbit_tpu_torch.ops import qp_lane

    t0 = time.perf_counter()
    path, log = qp_lane.build()
    phase("build", seconds=time.perf_counter() - t0, library=str(path.name),
          ptxas=ptxas_summary(log))


def phase_kernel_admm():
    """Kernel vs twin through ``solve_qp``; returns the main-path row."""
    from morbit_tpu_torch.ops import qp_lane
    from morbit_tpu_torch.ops.qp import _rho_vec, solve_qp

    sets = [("random", 3, 6, random_qps(B_MAIN, 3, 6, 0)),
            ("random", 4, 8, random_qps(B_MAIN, 4, 8, 1)),
            ("descent", 3, 6, descent_lps(B_MAIN, 2)),
            ("descent", 4, 8, descent_lps(B_MAIN, 3))]
    main_row = None
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 2e-3)):
        f32 = dtype == torch.float32
        for kind, nv, m, arrays in sets:
            P, q, A, lo, hi = (torch.as_tensor(a, dtype=dtype, device="cuda")
                               for a in arrays)
            qp_lane.launches = 0
            sol_k = solve_qp(P, q, A, lo, hi, iters=QP_ITERS, adapt_every=ADAPT_EVERY)
            with mock.patch.object(qp_lane, "admm_stages", qp_lane.admm_stages_plain):
                sol_p = solve_qp(P, q, A, lo, hi, iters=QP_ITERS,
                                 adapt_every=ADAPT_EVERY)
            torch.cuda.synchronize()
            check(qp_lane.launches == 1, f"kernel launches {qp_lane.launches} != 1")
            ok = sol_p.status_ok
            check(bool((sol_k.status_ok == ok).all()),
                  f"status_ok differs on {int((sol_k.status_ok != ok).sum())} lanes")

            # the kernel's own output: the stage loop on the equilibrated
            # inputs solve_qp gives it, against the twin's
            r = A.abs().amax(-1)
            args = (P, q, (A / r[..., None]).contiguous(), (lo / r).contiguous(),
                    (hi / r).contiguous(), _rho_vec(lo, hi, 0.1))
            kw = dict(n_stages=QP_ITERS // ADAPT_EVERY, n_steps=ADAPT_EVERY,
                      sigma=1e-4 if f32 else 1e-6, alpha=1.6,
                      rho_lo=1e-3 if f32 else 1e-6, rho_hi=1e4 if f32 else 1e6)
            z_k = qp_lane.admm_stages_cuda(*args, **kw)[0]
            z_p = qp_lane.admm_stages_plain(*args, **kw)[0]
            err = float((z_k - z_p)[ok].abs().max()) if ok.any() else 0.0
            check(err <= tol, f"{kind} nv={nv} m={m} {dtype}: |dz| {err} > {tol}")
            # after the polish: equal at float64; at float32 the polish takes
            # the active set from the ADMM dual signs and accepts it on KKT
            # residuals alone, so on lanes the 400 trips leave unconverged
            # two rounding orders can polish to different points (the JAX
            # package's float32 solve_qp does the same)
            dz_pol = (sol_k.z - sol_p.z).abs().amax(-1)
            pol_err = float(dz_pol[ok].max()) if ok.any() else 0.0
            if not f32:
                check(pol_err <= tol, f"{kind} nv={nv} m={m} {dtype}: polished "
                      f"|dz| {pol_err} > {tol}")
            ms = event_ms(lambda: qp_lane.admm_stages_cuda(*args, **kw), 20)
            ms_back_to_back = event_ms(
                lambda: [qp_lane.admm_stages_cuda(*args, **kw)
                         for _ in range(20)], 1) / 20
            plain_ms = event_ms(lambda: qp_lane.admm_stages_plain(*args, **kw), 5)
            launches = qp_lane.launches
            flops = B_MAIN * admm_flops(nv, m, kw["n_stages"], kw["n_steps"])
            nbytes = B_MAIN * admm_bytes(nv, m, P.element_size())
            t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
            row = dict(set=kind, nv=nv, m=m, dtype=str(dtype), B=B_MAIN,
                       ok_lanes=int(ok.sum()), max_abs_err=err, tol=tol,
                       polished_max_abs_err=pol_err,
                       polished_lanes_over_tol=int((ok & (dz_pol > tol)).sum()),
                       ms=ms, ms_back_to_back=ms_back_to_back,
                       plain_ms=plain_ms, launches=launches,
                       bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       flops=flops, bytes=nbytes)
            phase("kernel_admm", **row)
            if kind == "descent" and nv == 3 and f32:
                main_row = row
    return main_row


def phase_card_vs_cpu():
    from morbit_tpu_torch import AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.problems.synthetic import halton_starts, make_two_parabolas
    from morbit_tpu_torch.utils.logging import trajectory_arrays

    lb, ub = [-4.0, -4.0], [4.0, 4.0]
    starts = halton_starts(64, lb, ub)
    ac = AlgorithmConfig(max_iter=100, qp_iters=QP_ITERS)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = multistart_optimize(make_two_parabolas(lb=lb, ub=ub), starts,
                                        ac, dtype=torch.float64, device=dev)
        runs[dev + "_s"] = time.perf_counter() - t0
    gpu, cpu = runs["cuda"], runs["cpu"]
    eq = lambda a, b: bool(torch.equal(a.cpu(), b.cpu()))
    check(eq(gpu.stop_code, cpu.stop_code), "stop codes differ")
    check(eq(gpu.n_iterations, cpu.n_iterations), "iteration counts differ")
    for g_gpu, g_cpu in zip(gpu.state.groups, cpu.state.groups):
        check(eq(g_gpu.n_evals, g_cpu.n_evals), "eval counts differ")
    err = 0.0
    for i in range(64):
        tg, tc = trajectory_arrays(gpu, i), trajectory_arrays(cpu, i)
        check(np.array_equal(tg["it_stat"], tc["it_stat"]), f"it_stat differs, lane {i}")
        check(np.array_equal(tg["x_indices"], tc["x_indices"]),
              f"x_indices differ, lane {i}")
    for name in ("x", "fx"):
        err = max(err, float((getattr(gpu, name).cpu() - getattr(cpu, name)).abs().max()))
    check(err <= 1e-9, f"card vs cpu |dx|, |dfx| = {err} > 1e-9")
    phase("card_vs_cpu", B=64, dtype="float64", max_abs_err=err,
          trips_cuda=gpu.trips, trips_cpu=cpu.trips,
          seconds_cuda=runs["cuda_s"], seconds_cpu=runs["cpu_s"])


def pareto_fraction(x, tol=1e-2):
    """Share of lanes within ``tol`` of the two-parabolas Pareto set, the
    segment x1 = x2 in [-1, 1]."""
    t = torch.clamp(x.mean(-1, keepdim=True), -1.0, 1.0)
    return float(((x - t).norm(dim=-1) <= tol).double().mean())


def phase_main_path():
    from morbit_tpu_torch import STOP_CODE, AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.ops import qp_lane
    from morbit_tpu_torch.problems.synthetic import halton_starts, make_two_parabolas

    lb, ub = [-4.0, -4.0], [4.0, 4.0]
    mop = make_two_parabolas(lb=lb, ub=ub)
    ac = AlgorithmConfig(max_iter=100, qp_iters=QP_ITERS)
    starts = [torch.as_tensor(halton_starts(B_MAIN, lb, ub, 1 + k * B_MAIN),
                              dtype=torch.float32, device="cuda")
              for k in range(5)]
    torch.cuda.synchronize()

    qp_lane.launches = 0
    t0 = time.perf_counter()
    res = multistart_optimize(mop, starts[0], ac, dtype=torch.float32)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = qp_lane.launches
    check(launches >= res.trips, f"kernel launches {launches} < trips {res.trips}")
    check(bool(((res.stop_code >= STOP_CODE.MAX_ITER)
                & (res.stop_code <= STOP_CODE.INFEASIBLE)).all()), "invalid stop code")
    check(bool(torch.isfinite(res.x).all() and torch.isfinite(res.fx).all()),
          "non-finite x or fx")
    check(tuple(res.x.shape) == (B_MAIN, 2), f"x has shape {tuple(res.x.shape)}")

    # sustained protocol: back-to-back batches on distinct pre-staged starts
    t0 = time.perf_counter()
    trips = []
    for x0 in starts[1:]:
        trips.append(multistart_optimize(mop, x0, ac, dtype=torch.float32).trips)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    codes = {STOP_CODE(c).name: int((res.stop_code == c).sum())
             for c in range(2, 7)}
    phase("main_path", B=B_MAIN, dtype="float32", max_iter=100, qp_iters=QP_ITERS,
          launches=launches, trips=res.trips, first_batch_s=first_s,
          runs_per_s=len(trips) * B_MAIN / dt, sustained_batches=len(trips),
          sustained_s=dt, trips_sustained=trips,
          pareto_fraction_1e2=pareto_fraction(res.x),
          mean_iterations=float(res.n_iterations.double().mean()),
          mean_evals=float(res.n_evals.double().mean()), stop_codes=codes)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    row = phase_kernel_admm()
    phase_card_vs_cpu()
    launches = phase_main_path()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    check(row is not None and math.isfinite(row["ms"]), "no main-path kernel row")
    print(json.dumps({"kernels": [{
        "name": "qp_admm",
        "route": "cuda",
        "source": "morbit_tpu_torch/csrc/qp_admm.cu",
        "replaces": "morbit_tpu/ops/qp_lane.py:289",
        "launches": launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
