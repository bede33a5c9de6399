"""Chip smoke test of the PyTorch/CUDA port (``morbit_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. ``build``            — nvcc-builds the three kernels at once: K1
   (``csrc/qp_admm.cu``), K2 (``csrc/rbf_selection.cu``), K3
   (``csrc/rbf_round4.cu``).
2. ``kernel_admm``      — K1 against its plain PyTorch twin on the card,
   B=1024 random QPs and descent LPs, float32 and float64.
3. ``rbf_main_path``    — the main path: ``multistart_optimize`` on 1024
   Halton starts of two parabolas, both objectives in one multiquadric RBF
   group, float32, max_iter=100, qp_iters=400; launch counts of K1-K3 per
   batch, trips, Pareto-set fraction, the sustained rate. Its first batch
   records the K2/K3 inputs of some trips.
4. ``kernel_selection`` — K2 against its twin on the card: B=1024 random
   cases (n=2, 3; cap=157, 1507; the ensure-fully-linear flag half set) and
   the recorded main-path inputs, float64 and float32: integer and bool
   outputs equal on every lane, sites3/dirs within 1e-12 (float64) or 1e-5
   (float32).
5. ``kernel_round4``    — K3 against its twin on the card: B=1024, C=60,
   maxN=6 (multiquadric and cubic with a linear tail, multiquadric with a
   constant tail) and the recorded main-path inputs: ``accepted`` and ``N``
   equal on every lane, with rejections present.
6. ``rbf_card_vs_cpu``  — the RBF main path at float64, 64 Halton starts,
   max_iter=100, on the card and on the CPU, trip by trip from the same
   state (integer leaves equal, floats within 1e-9 + 1e-6 |x|), and run
   freely on both (the lanes that end alike; on them x within 1e-9 and fx,
   whose slope is at most 10 on the box, within 1e-8).
7. ``card_vs_cpu`` and ``main_path`` — the same two checks with exact models
   (slice 1), at 64 and 1024 starts.

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
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
B_MAIN = 1024
QP_ITERS, ADAPT_EVERY = 400, 100
LB, UB = [-4.0, -4.0], [4.0, 4.0]
#: rounds-1-3 statics of the main path's RbfConfig (theta_1 = theta_2 = 2,
#: theta_pivot = 1/4) under the default AlgorithmConfig (delta_max = 1/2)
SEL_STATICS = dict(theta_e1=2.0, theta_e2_dmax=1.0, theta_pivot=0.25,
                   delta_max=0.5, skip2_same_theta=True)
SEL_NAMES = ("r1_idx", "r1_cnt", "r2_idx", "r2_cnt", "sites3", "active3",
             "n_new", "dirs", "dirs_count", "fully_linear")
#: main-path trips whose K2/K3 inputs the first batch records
CAPTURE_TRIPS = (0, 1, 2, 5, 10, 20)


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


def selection_case(rng, B, cap, n, efl):
    """Random rounds-1-3 inputs in the pattern of tests/test_prepare_fused.py
    (numpy): sites, fill count, iterate, center row, radius, box, new-site
    budget and the ensure-fully-linear flag ('false', 'true' or 'mixed')."""
    X = rng.uniform(0, 1, (B, cap, n))
    count = rng.integers(1, cap, B).astype(np.int32)
    x_s = rng.uniform(0.2, 0.8, (B, n))
    x_index = np.zeros(B, np.int32)
    delta = rng.uniform(0.01, 0.3, B)
    delta[0] = 0.5                 # isclose(delta, delta_max): round 2 skipped
    lb, ub = np.zeros((B, n)), np.ones((B, n))
    max_new = rng.integers(0, 10, B).astype(np.int32)
    efl = {"false": np.zeros(B, bool), "true": np.ones(B, bool),
           "mixed": np.arange(B) % 2 == 0}[efl]
    return X, count, x_s, x_index, delta, lb, ub, max_new, efl


def round4_case(rng, B, C, n, maxN, dup_frac):
    """Random round-4 inputs in the pattern of tests/test_round4_fused.py
    (numpy): candidates with near-duplicates, candidate mask, rounds-1-3
    sites, their count and the shape parameter."""
    X = rng.uniform(0, 1, (B, C, n))
    ndup = int(C * dup_frac)
    for b in range(B):
        src, dst = rng.integers(0, C, ndup), rng.integers(0, C, ndup)
        X[b, dst] = X[b, src] + rng.normal(0, 1e-6, (ndup, n))
    cand = rng.uniform(size=(B, C)) < 0.7
    count = rng.integers(1, maxN, B).astype(np.int32)
    init = rng.uniform(0, 1, (B, maxN, n))
    init = np.where((np.arange(maxN)[None, :] < count[:, None])[..., None], init, 0.0)
    param = rng.uniform(0.5, 2.0, B)
    return X, cand, init, count, param


def selection_work(args, outs):
    """(operations, bytes) of one K2 call on these inputs, counted from the
    kernel's loops: each greedy scan visits the lane's valid rows at
    ~6n + 4n^2 operations a row (box tests, shift, complement projection,
    inf-norm); the valid rows are read once."""
    X, count, efl = args[0], args[1], args[8]
    B, cap, n = X.shape
    item = X.element_size()
    rows = torch.clamp(count.long(), 0, cap)
    r1 = (outs[0] >= 0).sum(-1).long()
    scans1 = torch.where(r1 < n, r1 + 1, torch.full_like(r1, n))
    pick2 = n - r1
    r2 = (outs[2] >= 0).sum(-1).long()
    scans2 = torch.where(efl | (pick2 == 0), torch.zeros_like(r2),
                         torch.minimum(r2 + 1, pick2))
    ops = int(((scans1 + scans2) * rows).sum()) * (6 * n + 4 * n * n)
    ops += int((r1 + r2).sum()) * 4 * n ** 3
    nbytes = int(rows.sum()) * n * item + B * (3 * n * item + item + 13)
    nbytes += B * (2 * n * 4 + 16 + n + 1 + 2 * n * n * item)
    return ops, nbytes


def round4_work(args, kw, accepted, N):
    """(operations, bytes) of one K3 call on these inputs, counted from the
    kernel's loops: each candidate tested before the scan stops costs
    ~M(3n+6) + pd(4pd+3M+8) + 6M^2 operations (M = max_points), each
    acceptance ~6 pd M + 4 M^2; the tested rows are read once."""
    X, cand, init, count = args
    B, C, n = X.shape
    M, item = kw["max_points"], X.element_size()
    pd = n + 1 if kw["poly_deg"] == 1 else (1 if kw["poly_deg"] == 0 else 0)
    cols = torch.arange(C, device=X.device)
    last = torch.where(accepted, cols, torch.full_like(cols, -1)).amax(-1)
    stop = torch.where(N >= M, last + 1, torch.full_like(last, C))
    stop = torch.where(count >= M, torch.zeros_like(stop), stop)
    tested = int((cand & (cols[None, :] < stop[:, None])).sum())
    n_acc = int(accepted.sum())
    ops = (tested * (M * (3 * n + 6) + pd * (4 * pd + 3 * M + 8) + 6 * M * M)
           + n_acc * (6 * pd * M + 4 * M * M))
    nbytes = (tested * n * item + B * C * 2 + int(count.sum()) * n * item
              + B * (item + 8))
    return ops, nbytes


def bound(ops, nbytes, dtype):
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def pareto_fraction(x, tol=1e-2):
    """Share of lanes within ``tol`` of the two-parabolas Pareto set, the
    segment x1 = x2 in [-1, 1]."""
    t = torch.clamp(x.mean(-1, keepdim=True), -1.0, 1.0)
    return float(((x - t).norm(dim=-1) <= tol).double().mean())


def rbf_mop():
    from morbit_tpu_torch.models.configs import RbfConfig
    from morbit_tpu_torch.problems.synthetic import make_two_parabolas

    return make_two_parabolas(RbfConfig(kernel="multiquadric"), LB, UB)


# ------------------------------------------------------------------- phases

def ptxas_summary(log):
    """Registers and spill bytes per kernel instance from ``-Xptxas=-v``
    output, keyed like ``f32_3_6`` (the instance's template sizes; 0 for
    runtime sizes)."""
    out, key = {}, None
    for line in log.splitlines():
        hit = re.search(r"_kernelI([fd])((?:Li\d+E)+)", line)
        if "Compiling entry function" in line and hit:
            sizes = "_".join(re.findall(r"Li(\d+)E", hit[2]))
            key = f"{'f32' if hit[1] == 'f' else 'f64'}_{sizes}"
        elif key and "spill stores" in line:
            out.setdefault(key, {})["spill_store_bytes"] = int(
                re.search(r"(\d+) bytes spill stores", line)[1])
        elif key and "Used" in line and "registers" in line:
            out.setdefault(key, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
    return out


def phase_build():
    from morbit_tpu_torch.ops import prepare_fused, qp_lane

    builds = {"qp_admm": qp_lane.build, "rbf_selection": prepare_fused.build_selection,
              "rbf_round4": prepare_fused.build_round4}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:     # one nvcc per source
        done = {k: pool.submit(fn) for k, fn in builds.items()}
        results = {k: f.result() for k, f in done.items()}
    phase("build", seconds=time.perf_counter() - t0,
          libraries={k: str(path.name) for k, (path, _) in results.items()},
          ptxas={k: ptxas_summary(log) for k, (_, log) in results.items()})


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


def phase_rbf_main_path():
    """The main path at float32, B=1024. The counts are set to 0 just before
    the first batch and read just after; that batch also records the K2/K3
    inputs of the trips in CAPTURE_TRIPS (copies, outside the kernels)."""
    from morbit_tpu_torch import STOP_CODE, AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.ops import prepare_fused, qp_lane
    from morbit_tpu_torch.problems.synthetic import halton_starts

    mop = rbf_mop()
    ac = AlgorithmConfig(max_iter=100, qp_iters=QP_ITERS)
    starts = [torch.as_tensor(halton_starts(B_MAIN, LB, UB, 1 + k * B_MAIN),
                              dtype=torch.float32, device="cuda")
              for k in range(5)]
    captured = {"selection": [], "round4": []}
    calls = {"selection": 0, "round4": 0}
    sel_fn, r4_fn = prepare_fused.selection, prepare_fused.round4

    def recording(name, fn):
        def wrapped(*args, **kw):
            if calls[name] in CAPTURE_TRIPS:
                captured[name].append((tuple(a.clone() for a in args), dict(kw)))
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    torch.cuda.synchronize()
    qp_lane.launches = prepare_fused.selection_launches = prepare_fused.round4_launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(prepare_fused, "selection", recording("selection", sel_fn)), \
            mock.patch.object(prepare_fused, "round4", recording("round4", r4_fn)):
        res = multistart_optimize(mop, starts[0], ac, dtype=torch.float32)
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"qp_admm": qp_lane.launches,
                "rbf_selection": prepare_fused.selection_launches,
                "rbf_round4": prepare_fused.round4_launches}
    for name, count in launches.items():
        check(count >= res.trips, f"{name} launched {count} times in {res.trips} trips")
    check(bool(((res.stop_code >= STOP_CODE.MAX_ITER)
                & (res.stop_code <= STOP_CODE.INFEASIBLE)).all()), "invalid stop code")
    check(bool(torch.isfinite(res.x).all() and torch.isfinite(res.fx).all()),
          "non-finite x or fx")
    check(tuple(res.x.shape) == (B_MAIN, 2), f"x has shape {tuple(res.x.shape)}")

    # sustained protocol: back-to-back batches on distinct pre-staged starts
    t0 = time.perf_counter()
    trips = [multistart_optimize(mop, x0, ac, dtype=torch.float32).trips
             for x0 in starts[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    codes = {STOP_CODE(c).name: int((res.stop_code == c).sum()) for c in range(2, 7)}
    phase("rbf_main_path", B=B_MAIN, dtype="float32", max_iter=100, qp_iters=QP_ITERS,
          model="RbfConfig(kernel='multiquadric')", launches=launches, trips=res.trips,
          first_batch_s=first_s, runs_per_s=len(trips) * B_MAIN / dt,
          sustained_batches=len(trips), sustained_s=dt, trips_sustained=trips,
          pareto_fraction_1e2=pareto_fraction(res.x),
          pareto_fraction_1e2_jax_cpu_f32=0.315,
          mean_iterations=float(res.n_iterations.double().mean()),
          mean_evals=float(res.n_evals.double().mean()), stop_codes=codes,
          db_capacity=int(res.state.groups[0].db.data.shape[1]))
    return launches, captured


def _selection_tensors(case, dtype):
    X, count, x_s, x_index, delta, lb, ub, max_new, efl = case
    f = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    i = lambda a: torch.as_tensor(a, dtype=torch.int32, device="cuda")
    return (f(X), i(count), f(x_s), i(x_index), f(delta), f(lb), f(ub), i(max_new),
            torch.as_tensor(efl, device="cuda"))


def phase_kernel_selection(captured):
    """K2 against its twin on the card; returns the row of the last recorded
    main-path call (float32, cap 1507)."""
    from morbit_tpu_torch.ops import prepare_fused
    from morbit_tpu_torch.ops.prepare_coord import rbf_selection_core

    sets = [(f"random_n{n}_cap{cap}", lambda dt, n=n, cap=cap: _selection_tensors(
        selection_case(np.random.default_rng(100 + n + cap), B_MAIN, cap, n, "mixed"),
        dt), SEL_STATICS) for n in (2, 3) for cap in (157, 1507)]
    sets += [(f"main_path_trip{t}", lambda dt, a=a: tuple(
        x.to(dt) if x.is_floating_point() else x for x in a), kw)
        for t, (a, kw) in zip(CAPTURE_TRIPS, captured)]
    main_row = None
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for name, make, kw in sets:
            args = make(dtype)
            before = prepare_fused.selection_launches
            k = prepare_fused.selection_cuda(*args, **kw)
            t = rbf_selection_core(*args, **kw)
            torch.cuda.synchronize()
            check(prepare_fused.selection_launches == before + 1, "K2 launch not counted")
            err, lanes = 0.0, torch.zeros(args[0].shape[0], dtype=torch.bool, device="cuda")
            for out, a, b in zip(SEL_NAMES, k, t):
                if a.is_floating_point():
                    d = (a - b).abs().reshape(a.shape[0], -1).amax(-1)
                    err = max(err, float(d.max()))
                    lanes |= d > tol
                else:
                    lanes |= (a != b).reshape(a.shape[0], -1).any(-1)
            bad = lanes.nonzero().flatten().tolist()
            for b_ in bad[:5]:
                print(json.dumps({"selection_lane_differs": name, "dtype": str(dtype),
                                  "lane": b_, "kernel": [o[b_].tolist() for o in k],
                                  "twin": [o[b_].tolist() for o in t]}), flush=True)
            check(not bad, f"K2 {name} {dtype}: {len(bad)} lanes differ from the twin")
            ms = event_ms(lambda: prepare_fused.selection_cuda(*args, **kw), 20)
            plain_ms = event_ms(lambda: rbf_selection_core(*args, **kw), 5)
            ops, nbytes = selection_work(args, k)
            bound_ms, bound_by = bound(ops, nbytes, dtype)
            row = dict(set=name, dtype=str(dtype), B=int(args[0].shape[0]),
                       cap=int(args[0].shape[1]), n=int(args[0].shape[2]),
                       max_valid_rows=int(args[1].max()), max_abs_err=err, tol=tol,
                       lanes_differing=len(bad), ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, ops=ops, bytes=nbytes)
            phase("kernel_selection", **row)
            if name.startswith("main_path") and dtype == torch.float32:
                main_row = row
    return main_row


def phase_kernel_round4(captured):
    """K3 against its twin on the card; returns the row of the last recorded
    main-path call (float32)."""
    from morbit_tpu_torch.models.rbf_round4 import run_round4
    from morbit_tpu_torch.ops import prepare_fused

    def random_set(kernel, deg):
        def make(dt):
            X, cand, init, count, param = round4_case(
                np.random.default_rng(11), B_MAIN, 60, 2, 6, 0.4)
            f = lambda a: torch.as_tensor(a, dtype=dt, device="cuda")
            kw = dict(kernel=kernel, param=3 if kernel == "cubic" else f(param),
                      poly_deg=deg, max_points=6, chol_pivot=0.3 if deg == 0 else 0.1)
            return (f(X), torch.as_tensor(cand, device="cuda"), f(init),
                    torch.as_tensor(count, dtype=torch.int32, device="cuda")), kw
        return make

    sets = [(f"random_{k}_deg{d}", random_set(k, d), True)
            for k, d in (("multiquadric", 1), ("cubic", 1), ("multiquadric", 0))]
    for t, (a, kw) in zip(CAPTURE_TRIPS, captured):
        def make(dt, a=a, kw=kw):
            kw = dict(kw)
            if isinstance(kw["param"], torch.Tensor):
                kw["param"] = kw["param"].to(dt)
            return tuple(x.to(dt) if x.is_floating_point() else x for x in a), kw
        sets.append((f"main_path_trip{t}", make, False))
    main_row = None
    for dtype in (torch.float64, torch.float32):
        for name, make, must_reject in sets:
            args, kw = make(dtype)
            before = prepare_fused.round4_launches
            acc_k, N_k = prepare_fused.round4_cuda(*args, **kw)
            acc_t, N_t = run_round4(*args, **kw)
            torch.cuda.synchronize()
            check(prepare_fused.round4_launches == before + 1, "K3 launch not counted")
            lanes = (acc_k != acc_t).any(-1) | (N_k != N_t)
            bad = lanes.nonzero().flatten().tolist()
            for b_ in bad[:5]:
                print(json.dumps({"round4_lane_differs": name, "dtype": str(dtype),
                                  "lane": b_, "kernel": acc_k[b_].nonzero().flatten().tolist(),
                                  "twin": acc_t[b_].nonzero().flatten().tolist(),
                                  "N": [int(N_k[b_]), int(N_t[b_])]}), flush=True)
            check(not bad, f"K3 {name} {dtype}: {len(bad)} lanes differ from the twin")
            if must_reject:
                check(int(N_t.min()) < kw["max_points"], f"K3 {name}: no rejection")
            ms = event_ms(lambda: prepare_fused.round4_cuda(*args, **kw), 20)
            plain_ms = event_ms(lambda: run_round4(*args, **kw), 5)
            ops, nbytes = round4_work(args, kw, acc_t, N_t)
            bound_ms, bound_by = bound(ops, nbytes, dtype)
            row = dict(set=name, dtype=str(dtype), B=int(args[0].shape[0]),
                       C=int(args[0].shape[1]), max_points=kw["max_points"],
                       kernel=kw["kernel"], poly_deg=kw["poly_deg"],
                       accepted=int(acc_t.sum()), min_N=int(N_t.min()),
                       max_abs_err=float((N_k - N_t).abs().max()),
                       lanes_differing=len(bad), ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, ops=ops, bytes=nbytes)
            phase("kernel_round4", **row)
            if name.startswith("main_path") and dtype == torch.float32:
                main_row = row
    return main_row


def _compare_states(card, cpu):
    """Leaf by leaf: integer leaves equal (the stamped it_stat and
    x_indices included), floats within 1e-9 + 1e-6 |x|. Two floats are
    reported instead of held to that: the stamped rho, a ratio of
    differences of nearly equal values near a critical point, and the
    fitted RBF coefficients, conditioned like the Gram matrix and seen only
    through the model values. Returns their largest relative differences."""
    from morbit_tpu_torch.utils.carry import state_to_numpy

    a, b = state_to_numpy(card), state_to_numpy(cpu)
    def rel(x, y):
        with np.errstate(invalid="ignore"):
            return float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1.0),
                                initial=0.0, where=np.isfinite(y)))
    rho_col = cpu.traj.n + cpu.traj.m + 1
    diffs = {"rho": 0.0, "fit": 0.0}
    for name, va in a.items():
        vb = b[name]
        if ".model.fit." in name:
            diffs["fit"] = max(diffs["fit"], rel(va, vb))
            continue
        if name == "traj.data":
            diffs["rho"] = max(diffs["rho"], rel(va[..., rho_col], vb[..., rho_col]))
            va, vb = np.delete(va, rho_col, -1), np.delete(vb, rho_col, -1)
        if va.dtype.kind in "biu":
            check(np.array_equal(va, vb), f"{name} differs")
        else:
            fin = np.isfinite(vb)
            check(np.array_equal(np.isfinite(va), fin), f"{name}: finiteness differs")
            check(np.array_equal(va[~fin], vb[~fin]), f"{name}: non-finite values differ")
            err = np.abs(va[fin] - vb[fin])
            check(bool(np.all(err <= 1e-9 + 1e-6 * np.abs(vb[fin]))),
                  f"{name}: |diff| {float(err.max(initial=0.0))}")
    return diffs


def phase_rbf_card_vs_cpu():
    """The RBF main path at float64 on the card and on the CPU."""
    from morbit_tpu_torch import STOP_CODE, AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.parallel.multistart import build_solver
    from morbit_tpu_torch.problems.synthetic import halton_starts
    from morbit_tpu_torch.utils.logging import trajectory_arrays
    from morbit_tpu_torch.utils.tree import tree_map, tree_where

    B = 64
    starts = halton_starts(B, LB, UB)
    ac = AlgorithmConfig(max_iter=100, qp_iters=QP_ITERS)
    on = {d: build_solver(rbf_mop(), ac, torch.float64, d) for d in ("cuda", "cpu")}

    # trip by trip: the card's trip from the CPU's state equals the CPU's trip
    t0 = time.perf_counter()
    state = on["cpu"].initialize(starts)
    diffs = _compare_states(on["cuda"].initialize(starts), state)
    trips = 0
    while bool((state.stop_code == STOP_CODE.CONTINUE).any()):
        card_in = tree_map(lambda t: t.to("cuda"), state)
        run_card = card_in.stop_code == STOP_CODE.CONTINUE
        card = tree_where(run_card, on["cuda"].iterate(card_in), card_in)
        running = state.stop_code == STOP_CODE.CONTINUE
        state = tree_where(running, on["cpu"].iterate(state), state)
        diffs = {k: max(v, d) for (k, v), d in zip(
            diffs.items(), _compare_states(card, state).values())}
        trips += 1
    lockstep_s = time.perf_counter() - t0

    # freely: lanes whose runs stay alike end alike
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = multistart_optimize(rbf_mop(), starts, ac, dtype=torch.float64,
                                        device=dev)
        runs[dev + "_s"] = time.perf_counter() - t0
    gpu, cpu = runs["cuda"], runs["cpu"]
    same, err_x, err_fx = 0, 0.0, 0.0
    for i in range(B):
        tg, tc = trajectory_arrays(gpu, i), trajectory_arrays(cpu, i)
        alike = (int(gpu.stop_code[i]) == int(cpu.stop_code[i])
                 and int(gpu.n_iterations[i]) == int(cpu.n_iterations[i])
                 and all(int(a.n_evals[i]) == int(b.n_evals[i])
                         for a, b in zip(gpu.state.groups, cpu.state.groups))
                 and np.array_equal(tg["it_stat"], tc["it_stat"])
                 and np.array_equal(tg["x_indices"], tc["x_indices"]))
        if alike:
            same += 1
            err_x = max(err_x, float((gpu.x[i].cpu() - cpu.x[i]).abs().max()))
            err_fx = max(err_fx, float((gpu.fx[i].cpu() - cpu.fx[i]).abs().max()))
    # |grad f| <= 10 on the box [-4, 4]^2, so fx inherits x's error times 10
    check(err_x <= 1e-9 and err_fx <= 1e-8,
          f"card vs cpu |dx| = {err_x} > 1e-9 or |dfx| = {err_fx} > 1e-8 "
          "on the lanes alike")
    phase("rbf_card_vs_cpu", B=B, dtype="float64", max_iter=100,
          lockstep_trips=trips, lockstep_s=lockstep_s,
          lockstep_rho_max_rel_diff=diffs["rho"], lockstep_fit_max_rel_diff=diffs["fit"],
          free_run_lanes_alike=same, free_run_max_abs_err_x=err_x,
          free_run_max_abs_err_fx=err_fx,
          trips_cuda=gpu.trips, trips_cpu=cpu.trips,
          seconds_cuda=runs["cuda_s"], seconds_cpu=runs["cpu_s"])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    admm_row = phase_kernel_admm()
    launches, captured = phase_rbf_main_path()
    sel_row = phase_kernel_selection(captured["selection"])
    r4_row = phase_kernel_round4(captured["round4"])
    phase_rbf_card_vs_cpu()
    phase_card_vs_cpu()
    phase_main_path()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rows = [("qp_admm", admm_row, "morbit_tpu_torch/csrc/qp_admm.cu",
             "morbit_tpu/ops/qp_lane.py:289"),
            ("rbf_selection", sel_row, "morbit_tpu_torch/csrc/rbf_selection.cu",
             "morbit_tpu/ops/prepare_fused.py:167"),
            ("rbf_round4", r4_row, "morbit_tpu_torch/csrc/rbf_round4.cu",
             "morbit_tpu/ops/prepare_fused.py:276")]
    for name, row, _, _ in rows:
        check(row is not None and math.isfinite(row["ms"]), f"no main-path row for {name}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
    } for name, row, source, replaces in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
