"""Chip smoke test of the PyTorch/CUDA port (``morbit_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. ``build``            — nvcc-builds the five kernels at once, one process
   per source: K1 (``csrc/qp_admm.cu``), K2 (``csrc/rbf_selection.cu``),
   K3 (``csrc/rbf_round4.cu``), K4 (``csrc/rbf_gram.cu``), K5
   (``csrc/admm_iterations.cu``); registers, stack and spills per instance.
2. ``rbf_main_path``    — the RBF main path: ``multistart_optimize`` on 1024
   Halton starts of two parabolas, both objectives in one multiquadric RBF
   group, float32, max_iter=100, qp_iters=400; launch counts of K1-K3 in
   the first batch, trips, Pareto-set fraction, the sustained rate. Its
   first batch records the K2/K3 inputs of some trips.
3. ``wide_main_path``   — the wide-n path: ZDT1 at n=20, both objectives in
   one cubic RBF group, the reference grid budget, float32, B_WIDE Halton
   starts; launches of K1-K4 per batch, trips, the front error, evaluations,
   stop codes, database rows, peak memory, the sustained rate. Its first
   batch records the K1-K4 inputs of some calls, and no plain twin may run
   on the card in it.
4. ``kernel_admm``, ``kernel_selection``, ``kernel_round4`` — K1, K2, K3
   against their twins on the card, on random cases (the wide shapes
   included: nv=21/m=42, n=20 with 5332 rows, max_points 231 with 2310
   rows; K1 also at (21, 42), (32, 64), (5, 10), (1, 2) with B=1000; K2
   also on lattice sites whose scores tie, with empty lanes and counts past
   the capacity, at n=20 and n=32; K3 also at the block instance's edges,
   ``round4_edge_case``) and the recorded inputs of both paths, float64
   and float32: K1 within 1e-9 (float64) or 2e-3 (float32); K2's and K3's
   outputs equal to the twins' on every lane, K2's floats to the bit. K3's
   rows give its bound under the live-size count (``round4_work``) and the
   padded kernel's count, and the tested and accepted candidates per lane.
5. ``kernel_gram``      — K4 against its twin: (P, n) = (134, 14) and
   (251, 20), all five RBF kernels, the edges of its tiling (P in 128,
   129, 251, 512 and n in 1, 20, 32), and the wide path's inputs; max|diff|
   / max|Phi| within 1e-12 (float64) or 1e-5 (float32), and the output
   exactly symmetric; timed over ten launches back to back.
6. ``kernel_admm_iterations`` — K5 (no caller) against its twin at
   (n, m) = (3, 6) and (21, 42), B=1024, 100 steps (both timed), and on
   its edge sets (``K5_EDGES``: (1, 1), (32, 64), (64, 128), B=1, B not a
   multiple of the instances a block, no steps, rows with infinite bounds),
   float64 and float32, within 1e-10 (float64) or 1e-4 (float32) times
   max(1, max|twin|).
7. ``wide_quality_f64`` — the wide path's problem at float64, B=4,
   max_iter=25, under the asserts of tests/test_zdt_quality.py:97-101.
8. ``wide_card_vs_cpu`` — ZDT1 at n=10 at float64 on the card and on the
   CPU, trip by trip from the same state.
9. ``rbf_card_vs_cpu``  — the RBF main path at float64, 64 Halton starts,
   max_iter=100, on the card and on the CPU, trip by trip from the same
   state (integer leaves equal, floats within 1e-9 + 1e-6 |x|), and run
   freely on both (the lanes that end alike; on them x within 1e-9 and fx,
   whose slope is at most 10 on the box, within 1e-8).
10. ``card_vs_cpu`` and ``main_path`` — the same two checks with exact
    models (slice 1), at 64 and 1024 starts.

Then the card's name and power limit, one JSON line with the kernel table,
and as the last line ``{"ok": true, "device": {...}}``. Without CUDA it
exits non-zero before printing any result. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
#: starts per batch of the wide-n path
B_WIDE = 1024
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
#: the wide-n path: ZDT1 at n=20 with both objectives in one cubic RBF
#: group, at the reference grid budget (morbit_tpu/parallel/benchmarks.py:
#: 104-118) and qp_iters=400; its RBF has max_points (n+1)(n+2)/2 = 231
N_WIDE = 20
WIDE_MAX_POINTS = (N_WIDE + 1) * (N_WIDE + 2) // 2
WIDE_BUDGET = dict(max_iter=100, max_evals=1000 * N_WIDE, delta_0=0.1, delta_max=0.5,
                   f_tol_rel=1e-3, x_tol_rel=1e-3, qp_iters=QP_ITERS)
WIDE_SUSTAINED = 2
#: calls of each kernel whose inputs the wide path's first batch records
WIDE_CAPTURE_CALLS = (2, 10)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def event_ms(fn, reps, inner=1):
    """Median of up to ``reps`` CUDA-event timings of ``fn()`` (after one
    warm-up), fewer once they add up to 2 s. With ``inner`` > 1 each timing
    spans that many calls back to back and is divided by it, so that a
    kernel shorter than its wrapper's host time is timed on the card, not
    at the host's launch rate."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
        if sum(times) * inner > 2000.0:
            break
    return statistics.median(times)


def timed(fn):
    """``fn()`` once, timed with CUDA events: (its result, ms). The plain
    twins are timed so, by the run that is compared with the kernel."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


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
    if m > 1:
        lo[:, 1], hi[:, 1] = -np.inf, np.inf
    if m > 2:
        lo[:, 2] = hi[:, 2] = Az[:, 2]
    return P, q, A, lo, hi


def admm_iterations_case(B, n, m, seed):
    """Inputs of K5 from ``random_qps``: the KKT inverse
    ``(P + sigma I + A' diag(rho) A)^-1`` at sigma = 1e-6 and a random
    per-row rho, from z = 0, zz = clip(0, l, u), y = 0."""
    P, q, A, lo, hi = random_qps(B, n, m, seed)
    rho = np.random.default_rng(seed).uniform(0.05, 5.0, (B, m))
    Minv = np.linalg.inv(P + 1e-6 * np.eye(n) + np.einsum("bri,br,brj->bij", A, rho, A))
    return (Minv, A, rho, q, lo, hi, np.zeros((B, n)), np.clip(0.0, lo, hi),
            np.zeros((B, m)))


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


def selection_lattice_case(rng, B, cap, n, efl):
    """Rounds-1-3 inputs whose scores tie exactly: sites on the lattice of
    step 1/8 in [0, 1]^n, the first half of each lane's rows repeated in its
    second half (equal scores at rows cap/2 apart, which fall to different
    threads and warps of the kernel's block), the iterate and the box edges
    on the lattice. Some lanes have no rows (count 0), some a count past the
    capacity; no NaN."""
    X = rng.integers(0, 9, (B, cap, n)) / 8.0
    half = cap // 2
    X[:, half:2 * half] = X[:, :half]
    count = rng.integers(1, cap, B).astype(np.int32)
    count[::5] = 0
    count[1::5] = cap + rng.integers(1, cap, len(count[1::5]))
    x_s = rng.integers(2, 7, (B, n)) / 8.0
    x_index = rng.integers(0, cap, B).astype(np.int32)
    delta = rng.integers(1, 5, B) / 16.0
    delta[0] = 0.5                 # isclose(delta, delta_max): round 2 skipped
    lb, ub = np.zeros((B, n)), np.ones((B, n))
    max_new = rng.integers(0, n + 2, B).astype(np.int32)
    efl = {"false": np.zeros(B, bool), "true": np.ones(B, bool),
           "mixed": np.arange(B) % 2 == 0}[efl]
    return X, count, x_s, x_index, delta, lb, ub, max_new, efl


def round4_case(rng, B, C, n, maxN, dup_frac, width=None):
    """Random round-4 inputs in the pattern of tests/test_round4_fused.py
    (numpy): candidates with near-duplicates, candidate mask, rounds-1-3
    sites (``width`` rows, ``maxN`` by default; the solver passes its
    training buffer, ``n`` rows wider), their count and the shape
    parameter."""
    X = rng.uniform(0, 1, (B, C, n))
    ndup = int(C * dup_frac)
    for b in range(B):
        src, dst = rng.integers(0, C, ndup), rng.integers(0, C, ndup)
        X[b, dst] = X[b, src] + rng.normal(0, 1e-6, (ndup, n))
    cand = rng.uniform(size=(B, C)) < 0.7
    count = rng.integers(1, maxN, B).astype(np.int32)
    width = width or maxN
    init = rng.uniform(0, 1, (B, width, n))
    init = np.where((np.arange(width)[None, :] < count[:, None])[..., None], init, 0.0)
    param = rng.uniform(0.5, 2.0, B)
    return X, cand, init, count, param


#: K3's edge sets at the wide shapes (``round4_edge_case``)
ROUND4_EDGES = ("n0_below_pd", "n0_zero", "full", "fill_to_max")


def round4_edge_case(rng, B, kind):
    """Round-4 inputs at the wide path's shapes (max_points 231, a 251-row
    training buffer, 2310 candidate rows) at the edges of K3's block
    instance; every third lane has no candidate, the others have them
    below a fill of at most 120 rows (the twin scans every column that
    holds one). ``n0_below_pd``: counts
    0-20, below pd = 21 (the rank test active); ``n0_zero``: no site yet;
    ``full``: half the lanes at or past max_points; ``fill_to_max``: counts
    1-21 and each of the first 400 rows a candidate, so most lanes fill to
    max_points with candidates left."""
    n, maxN = N_WIDE, WIDE_MAX_POINTS
    X, cand, init, count, param = round4_case(rng, B, 2310, n, maxN, 0.4, maxN + n)
    fill = rng.integers(n + 1, 120, B)
    if kind == "n0_below_pd":
        count = rng.integers(0, n + 1, B).astype(np.int32)
    elif kind == "n0_zero":
        count = np.zeros(B, np.int32)
    elif kind == "full":
        count = np.where(np.arange(B) % 2 == 0, rng.integers(maxN, maxN + n + 1, B),
                         count).astype(np.int32)
    else:
        count = rng.integers(1, n + 2, B).astype(np.int32)
        fill = np.full(B, 400)
        cand = np.ones_like(cand)
    cand &= np.arange(2310)[None, :] < fill[:, None]
    cand[::3] = False
    rows = np.arange(maxN + n)[None, :] < count[:, None]
    init = np.where(rows[..., None], rng.uniform(0, 1, init.shape), 0.0)
    return X, cand, init, count, param


def gram_case(rng, B, P, n):
    """Random K4 inputs: sites in the unit cube, ~70 % valid rows and a
    per-lane shape parameter in [0.5, 1] (the solver's default is 1). In
    float32, r^2 = |s_i|^2 + |s_j|^2 - 2 s_i.s_j carries a few ulps of
    |s|^2 ~ n/3 in either summation order, and phi moves by d phi / d r^2
    times that: p^2 for the gaussian, so larger shape parameters put kernel
    and twin further apart than 1e-5 max|Phi|."""
    return (rng.uniform(0, 1, (B, P, n)), rng.uniform(size=(B, P)) < 0.7,
            rng.uniform(0.5, 1.0, B))


def selection_work(args, outs):
    """(operations, bytes) of one K2 call on these inputs, counted from the
    block instance's loops: each round tests the lane's valid rows against
    its boxes once (2n operations a row and box); each greedy scan visits
    the round's candidates not yet taken, the first pick of a call at 2n
    operations a row and later ones at 4n(n - k) (the complement projection
    and its inf-norm; k picks in the span); each accepted pick updates the
    complement at ~4n(k + 2n). The valid rows are read once."""
    X, count, x_s, x_index, delta, lb_s, ub_s, _, efl = args
    B, cap, n = X.shape
    item = X.element_size()
    st = SEL_STATICS
    rows = torch.clamp(count.long(), 0, cap)
    valid = torch.arange(cap, device=X.device)[None, :] < rows[:, None]
    valid &= torch.arange(cap, device=X.device)[None, :] != x_index[:, None].long()
    d1 = (st["theta_e1"] * delta)[:, None]
    d2 = st["theta_e2_dmax"]
    in_box = lambda lo, hi: ((X >= lo[:, None]) & (X <= hi[:, None])).all(-1)
    in1 = in_box(torch.maximum(lb_s, x_s - d1), torch.minimum(ub_s, x_s + d1))
    in2 = in_box(torch.maximum(lb_s, x_s - d2), torch.minimum(ub_s, x_s + d2))
    cand1 = (valid & in1).sum(-1)
    cand2 = (valid & ~in1 & in2).sum(-1)
    r1 = (outs[0] >= 0).sum(-1).long()
    r2 = (outs[2] >= 0).sum(-1).long()
    ran2 = ~efl & (r1 < n)

    def scans(ncand, k0, picks, n_pick, on):
        ops = torch.zeros_like(ncand)
        n_scans = torch.where(picks < n_pick, picks + 1, picks)
        for s_ in range(n):
            per_row = 2 * n if s_ == 0 else 4 * n * torch.clamp(n - (k0 + s_), min=0)
            ops += torch.where(on & (s_ < n_scans), (ncand - s_).clamp(min=0) * per_row, 0)
        return ops

    ops = rows * 2 * n + torch.where(ran2, rows * 4 * n, 0)
    ops += scans(cand1, torch.zeros_like(r1), r1, torch.full_like(r1, n),
                 torch.ones_like(efl))
    ops += scans(cand2, r1, r2, n - r1, ran2)
    k = r1 + r2
    ops += (r1 + r2) * 4 * n * (k + 2 * n)
    nbytes = int(rows.sum()) * n * item + B * (3 * n * item + item + 13)
    nbytes += B * (2 * n * 4 + 16 + n + 1 + 2 * n * n * item)
    return int(ops.sum()), nbytes


def round4_test_ops(N, zc, N0, n, pd):
    """Operations of one tested candidate at the live sizes (N sites, zc
    accepted, N0 at the start), whatever implements it: phi to the N sites
    (3n + 6 each), the pd Givens steps on the pd x pd block (~9 pd + 6 each),
    Qg (2 pd N), Phi Qg (2 N^2) with tmp and the two dot products (6 N),
    Z' tmp over the live triangle of Z (column z has N0 + z + 1 rows),
    L^-1 v over the triangle of L^-1 and its squared norm, and sigma."""
    v = 2 * (zc * (N0 + 1) + zc * (zc - 1) // 2)
    return (N * (3 * n + 6) + pd * (9 * pd + 6) + 2 * pd * N + 2 * N * N + 6 * N
            + v + zc * (zc + 1) + 2 * zc + 6)


def _at_least(x, lo):
    return max(x, lo) if isinstance(x, int) else x.clamp(min=lo)


def round4_accept_ops(N, zc, pd):
    """Operations of one acceptance at the live sizes: the pd rotations of
    Q's pd leading columns and the slot column on max(N + 1, pd) rows, and
    the new row of L^-1 (L^-1' Lv over its triangle, the divisions)."""
    return 6 * pd * _at_least(N + 1, pd) + zc * (zc + 1) + zc + 2


def round4_setup_ops(N0, n, pd):
    """Operations of a lane's set-up: Phi on the N0 x N0 block and the
    Householder QR of the N0 x pd polynomial block, whose reflection j is
    supported on rows [j, N0) and updates the N0 x pd block and the
    N0 x N0 block of Q."""
    ops = N0 * N0 * (3 * n + 6)
    for j in range(pd):
        live = _at_least(N0 - j, 0)
        ops = ops + (live > 0) * (4 * live + 10 + 2 * live * (pd + N0)
                                  + 3 * N0 * (pd + N0))
    return ops


def round4_tested(cand, accepted, count, max_points):
    """Replay each lane's acceptance sequence: (tested (B, C) bool, the
    count N and the accepted count zc before each column). A candidate is
    tested while the lane has room; its N is the start count plus the
    acceptances before it."""
    before = torch.cumsum(accepted.to(torch.int64), -1) - accepted.to(torch.int64)
    N = count.to(torch.int64)[:, None] + before
    return cand & (N < max_points), N, before


def round4_work(args, kw, accepted, N):
    """(operations, bytes) of one K3 call on these inputs at the live sizes:
    every tested candidate (``round4_tested``) costs ``round4_test_ops``,
    every acceptance ``round4_accept_ops``, every lane with room
    ``round4_setup_ops``; the tested rows, the flags, the start sites and
    the outputs are moved once."""
    X, cand, init, count = args
    B, C, n = X.shape
    M, item = kw["max_points"], X.element_size()
    pd = n + 1 if kw["poly_deg"] == 1 else (1 if kw["poly_deg"] == 0 else 0)
    tested, Nc, zc = round4_tested(cand, accepted, count, M)
    N0 = count.to(torch.int64)[:, None].expand_as(Nc)
    ops = int(torch.where(tested, round4_test_ops(Nc, zc, N0, n, pd), 0).sum())
    ops += int(torch.where(accepted, round4_accept_ops(Nc, zc, pd), 0).sum())
    room = count.to(torch.int64) < M
    ops += int(torch.where(room, round4_setup_ops(count.to(torch.int64), n, pd), 0).sum())
    nbytes = (int(tested.sum()) * n * item + B * C * 2 + int(count.sum()) * n * item
              + B * (item + 8))
    return ops, nbytes


def round4_work_padded(args, kw, accepted, N):
    """The count of the earlier, padded kernel (every loop over max_points
    M): each candidate tested before the scan stops costs ~M(3n+6) +
    pd(4pd+3M+8) + 6M^2 operations, each acceptance ~6 pd M + 4 M^2; the
    tested rows are read once. Printed beside the live count."""
    X, cand, init, count = args
    B, C, n = X.shape
    M, item = kw["max_points"], X.element_size()
    pd = n + 1 if kw["poly_deg"] == 1 else (1 if kw["poly_deg"] == 0 else 0)
    tested = int(round4_tested(cand, accepted, count, M)[0].sum())
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
    """Registers, static shared memory, stack and spill bytes per kernel
    instance from ``-Xptxas=-v`` output, keyed like ``qp_admm_f32_3_6`` (the
    kernel, its type and its template sizes; none for runtime sizes). The
    dynamic shared memory of the runtime-size instances is the wrappers'
    (``admm_smem_bytes``, ``selection_smem_bytes``)."""
    out, key = {}, None
    for line in log.splitlines():
        hit = re.search(r"(qp_admm_wide|qp_admm|rbf_selection_block|rbf_selection|"
                        r"rbf_round4_wide|rbf_round4|rbf_gram|admm_iterations)"
                        r"_kernelI([fd])((?:Li\d+E)*)", line)
        if "Compiling entry function" in line and hit:
            sizes = "".join("_" + v for v in re.findall(r"Li(\d+)E", hit[3]))
            key = f"{hit[1]}_{'f32' if hit[2] == 'f' else 'f64'}{sizes}"
        elif key and "spill stores" in line:
            out.setdefault(key, {})["spill_store_bytes"] = int(
                re.search(r"(\d+) bytes spill stores", line)[1])
            out[key]["stack_frame_bytes"] = int(
                re.search(r"(\d+) bytes stack frame", line)[1])
        elif key and "Used" in line and "registers" in line:
            out.setdefault(key, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
            smem = re.search(r"(\d+) bytes smem", line)
            out[key]["static_smem_bytes"] = int(smem[1]) if smem else 0
    return out


def phase_build():
    from morbit_tpu_torch.ops import dense_kernels, prepare_fused, qp_lane

    builds = {"qp_admm": qp_lane.build, "rbf_selection": prepare_fused.build_selection,
              "rbf_round4": prepare_fused.build_round4,
              "rbf_gram": dense_kernels.build_gram,
              "admm_iterations": dense_kernels.build_admm_iterations}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:     # one nvcc per source
        done = {k: pool.submit(fn) for k, fn in builds.items()}
        results = {k: f.result() for k, f in done.items()}
    phase("build", seconds=time.perf_counter() - t0,
          libraries={k: str(path.name) for k, (path, _) in results.items()},
          ptxas={k: ptxas_summary(log) for k, (_, log) in results.items()})


def phase_kernel_admm(wide_captured):
    """Kernel vs twin through ``solve_qp`` on random QPs, descent LPs and the
    LPs the wide path gave the kernel (recorded after equilibration, so
    ``solve_qp`` passes them on unchanged); returns the rows of the RBF main
    path's shape (nv=3 descent LPs, float32) and of the wide path (its last
    recorded call, float32).

    On the recorded wide LPs (P = 0, sigma = 1e-6 or 1e-4 in M = sigma I +
    A' diag(rho) A, 400 steps that leave many lanes unconverged) the stage
    loop amplifies rounding: perturbing A by one ulp moves the twin's own
    output by up to ~1e-7 (float64) or ~1e-2 (float32) on some lanes. Two
    rounding orders of it (kernel and twin) cannot agree closer than that,
    so there the kernel is held to the larger of the fixed tolerance and
    ten times that sensitivity, measured in the same run."""
    from morbit_tpu_torch.ops import qp_lane
    from morbit_tpu_torch.ops.qp import solve_qp

    def through_solve_qp(stages, P, q, A, lo, hi):
        """``solve_qp`` with ``stages`` as its stage loop; returns the
        solution, the loop's inputs and output, and its CUDA-event time."""
        seen = {}

        def wrapped(*args, **kw):
            seen["args"], seen["kw"] = args, kw
            out, seen["ms"] = timed(lambda: stages(*args, **kw))
            seen["z"] = out[0]
            return out
        with mock.patch.object(qp_lane, "admm_stages", wrapped):
            sol = solve_qp(P, q, A, lo, hi, iters=QP_ITERS, adapt_every=ADAPT_EVERY)
        return sol, seen

    sets = [("random", random_qps(B_MAIN, 3, 6, 0)),
            ("random", random_qps(B_MAIN, 4, 8, 1)),
            ("descent", descent_lps(B_MAIN, 2)),
            ("descent", descent_lps(B_MAIN, 3)),
            ("random", random_qps(B_MAIN, 21, 42, 2))]
    # the warp-per-lane instance at its edges: two rows a thread (m > 32),
    # nv = 1, B not a multiple of the lanes in a block
    sets += [("random_B1000", random_qps(1000, nv, m, 3 + nv))
             for nv, m in ((21, 42), (32, 64), (5, 10), (1, 2))]
    sets += [(f"wide_path_call{c}", a[:5]) for c, (a, _) in zip(WIDE_CAPTURE_CALLS,
                                                                 wide_captured)]
    rows = {}
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 2e-3)):
        f32 = dtype == torch.float32
        for kind, arrays in sets:
            P, q, A, lo, hi = (torch.as_tensor(a, dtype=dtype, device="cuda")
                               for a in arrays)
            nv, m = A.shape[-1], A.shape[-2]
            qp_lane.launches = 0
            sol_k, k = through_solve_qp(qp_lane.admm_stages_cuda, P, q, A, lo, hi)
            check(qp_lane.launches == 1, f"kernel launches {qp_lane.launches} != 1")
            sol_p, t = through_solve_qp(qp_lane.admm_stages_plain, P, q, A, lo, hi)
            ok = sol_p.status_ok
            check(bool((sol_k.status_ok == ok).all()),
                  f"status_ok differs on {int((sol_k.status_ok != ok).sum())} lanes")
            dz = (k["z"] - t["z"]).abs().amax(-1)
            err = float(dz[ok].max()) if ok.any() else 0.0
            # after the polish: at float32 the polish takes the active set
            # from the ADMM dual signs and accepts it on KKT residuals alone,
            # so on lanes the 400 trips leave unconverged two rounding orders
            # can polish to different points (the JAX package's float32
            # solve_qp does the same); it is reported there, not held
            dz_pol = (sol_k.z - sol_p.z).abs().amax(-1)
            pol_err = float(dz_pol[ok].max()) if ok.any() else 0.0
            limit, extra = tol, {}
            if kind.startswith("wide_path"):
                a = t["args"]
                g = torch.Generator(device="cuda").manual_seed(0)
                A1 = a[2] * (1 + torch.finfo(dtype).eps
                             * torch.randn(a[2].shape, generator=g, device="cuda", dtype=dtype))
                z1 = qp_lane.admm_stages_plain(a[0], a[1], A1, *a[3:], **t["kw"])[0]
                sens = (z1 - t["z"]).abs().amax(-1)
                sens_max = float(sens[ok].max()) if ok.any() else 0.0
                limit = max(tol, 10.0 * sens_max)
                extra = dict(one_ulp_sensitivity=sens_max, held_to=limit,
                             lanes_within_tol=int((ok & (dz <= tol)).sum()))
            check(err <= limit, f"{kind} nv={nv} m={m} {dtype}: |dz| {err} > {limit}")
            if not f32:
                check(pol_err <= limit, f"{kind} nv={nv} m={m} {dtype}: polished "
                      f"|dz| {pol_err} > {limit}")
            row = admm_row(k["args"], k["kw"], dtype, t["ms"], set=kind,
                           ok_lanes=int(ok.sum()), max_abs_err=err, tol=tol, **extra,
                           polished_max_abs_err=pol_err,
                           polished_lanes_over_tol=int((ok & (dz_pol > tol)).sum()))
            phase("kernel_admm", **row)
            rows[(kind, nv, dtype)] = row
    wide = [v for (kind, _, dt), v in rows.items()
            if kind.startswith("wide_path") and dt == torch.float32]
    return rows[("descent", 3, torch.float32)], wide[-1]


def admm_row(args, kw, dtype, plain_ms, **fields):
    """Time the K1 launch on ``args`` and add its bound."""
    from morbit_tpu_torch.ops import qp_lane

    B, m, nv = args[2].shape
    ms = event_ms(lambda: qp_lane.admm_stages_cuda(*args, **kw), 20)
    k = 20 if ms < 5.0 else 2
    ms_back_to_back = event_ms(
        lambda: [qp_lane.admm_stages_cuda(*args, **kw) for _ in range(k)], 1) / k
    flops = B * admm_flops(nv, m, kw["n_stages"], kw["n_steps"])
    nbytes = B * admm_bytes(nv, m, args[0].element_size())
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    return dict(fields, nv=nv, m=m, dtype=str(dtype), B=B, ms=ms,
                ms_back_to_back=ms_back_to_back, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)


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
    torch.cuda.synchronize()
    qp_lane.launches = prepare_fused.selection_launches = prepare_fused.round4_launches = 0
    t0 = time.perf_counter()
    with kernels_only(), recording(captured, CAPTURE_TRIPS):
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


#: the wrappers whose inputs a path records, by the name of their captures
_RECORDED = {"qp_admm": ("qp_lane", "admm_stages"),
             "selection": ("prepare_fused", "selection"),
             "round4": ("prepare_fused", "round4"),
             "gram": ("dense_kernels", "rbf_gram_matrix")}


@contextlib.contextmanager
def recording(captured, calls_to_keep):
    """Record copies of the inputs of the wrappers named in ``captured``
    (a dict of empty lists) at the call numbers in ``calls_to_keep``; the
    copies are made outside the kernels and launch none."""
    from morbit_tpu_torch.ops import dense_kernels, prepare_fused, qp_lane

    mods = {"qp_lane": qp_lane, "prepare_fused": prepare_fused,
            "dense_kernels": dense_kernels}
    calls = dict.fromkeys(captured, 0)

    def wrap(name, fn):
        def wrapped(*args, **kw):
            if calls[name] in calls_to_keep:
                captured[name].append((tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a for a in args), dict(kw)))
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    with contextlib.ExitStack() as stack:
        for name in captured:
            mod, attr = _RECORDED[name]
            stack.enter_context(mock.patch.object(
                mods[mod], attr, wrap(name, getattr(mods[mod], attr))))
        yield


@contextlib.contextmanager
def kernels_only():
    """Make every plain twin raise on a CUDA tensor, so that a run shows it
    went through the kernels only."""
    from morbit_tpu_torch.ops import dense_kernels, prepare_fused, qp_lane

    def guard(name, fn):
        def wrapped(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise RuntimeError(f"the plain twin {name} ran on a CUDA tensor")
            return fn(*args, **kw)
        return wrapped

    twins = [(qp_lane, "admm_stages_plain"), (prepare_fused, "rbf_selection_core"),
             (prepare_fused, "run_round4"), (dense_kernels, "rbf_gram_matrix_plain"),
             (dense_kernels, "admm_iterations_plain")]
    with contextlib.ExitStack() as stack:
        for mod, attr in twins:
            stack.enter_context(mock.patch.object(mod, attr, guard(attr, getattr(mod, attr))))
        yield


def wide_mop():
    from morbit_tpu_torch.models.configs import RbfConfig
    from morbit_tpu_torch.problems.synthetic import make_zdt

    return make_zdt("zdt1", N_WIDE, model_cfg=RbfConfig(kernel="cubic"))


def front_error(fx):
    """|f2 - (1 - sqrt(f1))| per lane: the distance in f2 to the ZDT1
    front (``tests/test_zdt_quality.py::_front_err``)."""
    f1 = torch.clamp(fx[:, 0], min=0.0)
    return (fx[:, 1] - (1.0 - torch.sqrt(f1))).abs()


def _quantiles(t):
    t = t.double().cpu()
    return {"min": float(t.min()), "median": float(t.median()), "max": float(t.max())}


def phase_wide_main_path(B):
    """The wide-n path at float32: ZDT1, n=20, both objectives in one cubic
    RBF group, the reference grid budget, B Halton starts. The counts are
    set to 0 just before each batch and read just after it; the first batch
    records the K1-K4 inputs of the calls in WIDE_CAPTURE_CALLS, and no
    plain twin may run on the card in it."""
    from morbit_tpu_torch import STOP_CODE, AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.ops import dense_kernels, prepare_fused, qp_lane
    from morbit_tpu_torch.problems.synthetic import halton_starts

    mop = wide_mop()
    ac = AlgorithmConfig(**WIDE_BUDGET)
    starts = [torch.as_tensor(halton_starts(B, mop.lb, mop.ub, 1 + k * B),
                              dtype=torch.float32, device="cuda")
              for k in range(1 + WIDE_SUSTAINED)]
    captured = {"qp_admm": [], "selection": [], "round4": [], "gram": []}

    def counts():
        return {"qp_admm": qp_lane.launches,
                "rbf_selection": prepare_fused.selection_launches,
                "rbf_round4": prepare_fused.round4_launches,
                "rbf_gram": dense_kernels.gram_launches}

    def batch(x0, record):
        qp_lane.launches = prepare_fused.selection_launches = 0
        prepare_fused.round4_launches = dense_kernels.gram_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if record:
                stack.enter_context(kernels_only())
                stack.enter_context(recording(captured, WIDE_CAPTURE_CALLS))
            res = multistart_optimize(mop, x0, ac, dtype=torch.float32)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts()
        for name, count in launches.items():
            check(count >= res.trips,
                  f"{name} launched {count} times in {res.trips} trips of the wide path")
        return res, seconds, launches

    torch.cuda.reset_peak_memory_stats()
    res, first_s, launches = batch(starts[0], True)
    peak = torch.cuda.max_memory_allocated()
    check(bool(((res.stop_code >= STOP_CODE.MAX_ITER)
                & (res.stop_code <= STOP_CODE.INFEASIBLE)).all()), "invalid stop code")
    check(bool(torch.isfinite(res.x).all() and torch.isfinite(res.fx).all()),
          "non-finite x or fx")
    check(tuple(res.x.shape) == (B, N_WIDE), f"x has shape {tuple(res.x.shape)}")
    sustained = [batch(x0, False) for x0 in starts[1:]]
    dt = sum(s for _, s, _ in sustained)
    codes = {STOP_CODE(c).name: int((res.stop_code == c).sum()) for c in range(2, 7)}
    phase("wide_main_path", B=B, dtype="float32", n=N_WIDE, problem="zdt1",
          model="RbfConfig(kernel='cubic')", budget=WIDE_BUDGET,
          launches_per_batch=[launches] + [l for _, _, l in sustained],
          trips_per_batch=[res.trips] + [r.trips for r, _, _ in sustained],
          first_batch_s=first_s, sustained_s=[s for _, s, _ in sustained],
          runs_per_s=len(sustained) * B / dt,
          front_error=_quantiles(front_error(res.fx)),
          mean_iterations=float(res.n_iterations.double().mean()),
          mean_evals=float(res.n_evals.double().mean()), stop_codes=codes,
          db_rows=int(res.state.groups[0].db.data.shape[1]),
          max_memory_allocated_bytes=peak,
          recorded_calls={k: len(v) for k, v in captured.items()})
    return launches, captured


def _selection_tensors(case, dtype):
    X, count, x_s, x_index, delta, lb, ub, max_new, efl = case
    f = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    i = lambda a: torch.as_tensor(a, dtype=torch.int32, device="cuda")
    return (f(X), i(count), f(x_s), i(x_index), f(delta), f(lb), f(ub), i(max_new),
            torch.as_tensor(efl, device="cuda"))


def phase_kernel_selection(captured, wide_captured):
    """K2 against its twin on the card; returns the rows of the last
    recorded call of the RBF main path (cap 1507) and of the wide path
    (n=20, cap 5332), both float32."""
    from morbit_tpu_torch.ops import prepare_fused
    from morbit_tpu_torch.ops.prepare_coord import rbf_selection_core

    sets = [(f"random_n{n}_cap{cap}", lambda dt, n=n, cap=cap: _selection_tensors(
        selection_case(np.random.default_rng(100 + n + cap), B_MAIN, cap, n, "mixed"),
        dt), SEL_STATICS) for n, cap in ((2, 157), (2, 1507), (3, 157), (3, 1507),
                                         (N_WIDE, 5332))]
    # exact ties on a lattice, empty lanes and counts past the capacity
    sets += [(f"lattice_n{n}_cap{cap}", lambda dt, n=n, cap=cap: _selection_tensors(
        selection_lattice_case(np.random.default_rng(200 + n), B_MAIN, cap, n, "mixed"),
        dt), SEL_STATICS) for n, cap in ((N_WIDE, 1200), (32, 600))]
    recorded = lambda a: lambda dt: tuple(x.to(dt) if x.is_floating_point() else x
                                          for x in a)
    sets += [(f"main_path_trip{t}", recorded(a), kw)
             for t, (a, kw) in zip(CAPTURE_TRIPS, captured)]
    sets += [(f"wide_path_call{t}", recorded(a), kw)
             for t, (a, kw) in zip(WIDE_CAPTURE_CALLS, wide_captured)]
    rows = {}
    for dtype in (torch.float64, torch.float32):
        for name, make, kw in sets:
            args = make(dtype)
            before = prepare_fused.selection_launches
            k = prepare_fused.selection_cuda(*args, **kw)
            t, plain_ms = timed(lambda: rbf_selection_core(*args, **kw))
            check(prepare_fused.selection_launches == before + 1, "K2 launch not counted")
            # every output equal to the twin's, floats to the bit (NaN where
            # the twin has NaN)
            err, lanes = 0.0, torch.zeros(args[0].shape[0], dtype=torch.bool, device="cuda")
            for out, a, b in zip(SEL_NAMES, k, t):
                if a.is_floating_point():
                    d = (a - b).abs().reshape(a.shape[0], -1)
                    same = ((a == b) | (a.isnan() & b.isnan())).reshape(a.shape[0], -1)
                    err = max(err, float(torch.nan_to_num(d, nan=0.0).max()))
                    lanes |= ~same.all(-1)
                else:
                    lanes |= (a != b).reshape(a.shape[0], -1).any(-1)
            bad = lanes.nonzero().flatten().tolist()
            for b_ in bad[:5]:
                print(json.dumps({"selection_lane_differs": name, "dtype": str(dtype),
                                  "lane": b_, "kernel": [o[b_].tolist() for o in k],
                                  "twin": [o[b_].tolist() for o in t]}), flush=True)
            check(not bad, f"K2 {name} {dtype}: {len(bad)} lanes differ from the twin")
            ms = event_ms(lambda: prepare_fused.selection_cuda(*args, **kw), 5)
            ops, nbytes = selection_work(args, k)
            bound_ms, bound_by = bound(ops, nbytes, dtype)
            row = dict(set=name, dtype=str(dtype), B=int(args[0].shape[0]),
                       cap=int(args[0].shape[1]), n=int(args[0].shape[2]),
                       max_valid_rows=int(args[1].max()), max_abs_err=err, tol=0.0,
                       lanes_differing=len(bad), ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, ops=ops, bytes=nbytes)
            phase("kernel_selection", **row)
            rows[(name.split("_trip")[0].split("_call")[0], dtype)] = row
    return rows[("main_path", torch.float32)], rows[("wide_path", torch.float32)]


def phase_kernel_round4(captured, wide_captured):
    """K3 against its twin on the card; returns the rows of the last
    recorded call of the RBF main path and of the wide path, float32."""
    from morbit_tpu_torch.models.rbf_round4 import run_round4
    from morbit_tpu_torch.ops import prepare_fused

    def random_set(kernel, deg, B, C, n, maxN, chol_pivot, width=None, rows=None):
        def make(dt):
            X, cand, init, count, param = round4_case(
                np.random.default_rng(11), B, C, n, maxN, 0.4, width)
            if rows is not None:
                # candidates only below a database fill count, as the solver
                # gives them
                fill = np.random.default_rng(12).integers(n + 1, rows, B)
                cand &= np.arange(C)[None, :] < fill[:, None]
            f = lambda a: torch.as_tensor(a, dtype=dt, device="cuda")
            kw = dict(kernel=kernel, param=3 if kernel == "cubic" else f(param),
                      poly_deg=deg, max_points=maxN, chol_pivot=chol_pivot)
            return (f(X), torch.as_tensor(cand, device="cuda"), f(init),
                    torch.as_tensor(count, dtype=torch.int32, device="cuda")), kw
        return make

    def recorded(a, kw):
        def make(dt):
            kw2 = dict(kw)
            if isinstance(kw2["param"], torch.Tensor):
                kw2["param"] = kw2["param"].to(dt)
            return tuple(x.to(dt) if x.is_floating_point() else x for x in a), kw2
        return make

    sets = [(f"random_{k}_deg{d}", random_set(k, d, B_MAIN, 60, 2, 6,
                                              0.3 if d == 0 else 0.1), True)
            for k, d in (("multiquadric", 1), ("cubic", 1), ("multiquadric", 0))]
    # the wide path's shapes: max_points 231, a 251-row training buffer,
    # 2310 candidate rows of which those below a fill count of at most 300
    # (the database of the path's first ~10 trips) are candidates, the
    # path's pivot (theta_pivot_cholesky = 1e-7)
    sets.append(("random_wide_cubic_deg1", random_set(
        "cubic", 1, B_MAIN, 2310, N_WIDE, WIDE_MAX_POINTS, 1e-14,
        width=WIDE_MAX_POINTS + N_WIDE, rows=300), True))
    # the block instance's edges at the wide shapes (B=64: the twin scans
    # every column that holds a candidate)
    for kind in ROUND4_EDGES:
        def edge(dt, kind=kind):
            X, cand, init, count, _ = round4_edge_case(np.random.default_rng(7), 64, kind)
            f = lambda a: torch.as_tensor(a, dtype=dt, device="cuda")
            return (f(X), torch.as_tensor(cand, device="cuda"), f(init),
                    torch.as_tensor(count, dtype=torch.int32, device="cuda")), dict(
                kernel="cubic", param=3, poly_deg=1, max_points=WIDE_MAX_POINTS,
                chol_pivot=1e-14)
        sets.append((f"wide_edge_{kind}", edge, False))
    sets += [(f"main_path_trip{t}", recorded(a, kw), False)
             for t, (a, kw) in zip(CAPTURE_TRIPS, captured)]
    sets += [(f"wide_path_call{t}", recorded(a, kw), False)
             for t, (a, kw) in zip(WIDE_CAPTURE_CALLS, wide_captured)]
    rows = {}
    for dtype in (torch.float64, torch.float32):
        for name, make, must_reject in sets:
            args, kw = make(dtype)
            before = prepare_fused.round4_launches
            acc_k, N_k = prepare_fused.round4_cuda(*args, **kw)
            (acc_t, N_t), plain_ms = timed(lambda: run_round4(*args, **kw))
            check(prepare_fused.round4_launches == before + 1, "K3 launch not counted")
            lanes = (acc_k != acc_t).any(-1) | (N_k != N_t)
            bad = lanes.nonzero().flatten().tolist()
            for b_ in bad[:5]:
                print(json.dumps({"round4_lane_differs": name, "dtype": str(dtype),
                                  "lane": b_, "kernel": acc_k[b_].nonzero().flatten().tolist(),
                                  "twin": acc_t[b_].nonzero().flatten().tolist(),
                                  "N": [int(N_k[b_]), int(N_t[b_])]}), flush=True)
            check(not bad, f"K3 {name} {dtype}: {len(bad)} lanes differ from the twin")
            # a tested candidate (one met while the lane had room) was rejected
            room = torch.cumsum(acc_t.int(), -1) < kw["max_points"] - args[3][:, None]
            rejected = int((args[1] & room & ~acc_t).sum())
            if must_reject:
                check(rejected > 0, f"K3 {name}: no rejection")
            ms = event_ms(lambda: prepare_fused.round4_cuda(*args, **kw), 5)
            ops, nbytes = round4_work(args, kw, acc_t, N_t)
            bound_ms, bound_by = bound(ops, nbytes, dtype)
            ops_padded, _ = round4_work_padded(args, kw, acc_t, N_t)
            tested = round4_tested(args[1], acc_t, args[3], kw["max_points"])[0].sum(-1)
            row = dict(set=name, dtype=str(dtype), B=int(args[0].shape[0]),
                       C=int(args[0].shape[1]), n=int(args[0].shape[2]),
                       max_points=kw["max_points"], kernel=kw["kernel"],
                       poly_deg=kw["poly_deg"], accepted=int(acc_t.sum()),
                       rejected=rejected, min_N=int(N_t.min()), max_N=int(N_t.max()),
                       tested_max=int(tested.max()),
                       tested_median=float(tested.double().median()),
                       accepted_max=int(acc_t.sum(-1).max()),
                       max_abs_err=float((N_k - N_t).abs().max()),
                       lanes_differing=len(bad), ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, ops=ops, bytes=nbytes,
                       bound_ms_padded_count=bound(ops_padded, nbytes, dtype)[0],
                       ops_padded_count=ops_padded)
            phase("kernel_round4", **row)
            rows[(name.split("_trip")[0].split("_call")[0], dtype)] = row
    return rows[("main_path", torch.float32)], rows[("wide_path", torch.float32)]


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


def lockstep(make_mop, starts, ac):
    """Trip by trip at float64: the card's trip from the CPU's state equals
    the CPU's trip (``_compare_states``). Returns the trips, the seconds and
    the largest relative differences of the reported floats."""
    from morbit_tpu_torch import STOP_CODE
    from morbit_tpu_torch.parallel.multistart import build_solver
    from morbit_tpu_torch.utils.tree import tree_map, tree_where

    on = {d: build_solver(make_mop(), ac, torch.float64, d) for d in ("cuda", "cpu")}
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
    return trips, time.perf_counter() - t0, diffs


def phase_rbf_card_vs_cpu():
    """The RBF main path at float64 on the card and on the CPU."""
    from morbit_tpu_torch import AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.problems.synthetic import halton_starts
    from morbit_tpu_torch.utils.logging import trajectory_arrays

    B = 64
    starts = halton_starts(B, LB, UB)
    ac = AlgorithmConfig(max_iter=100, qp_iters=QP_ITERS)
    trips, lockstep_s, diffs = lockstep(rbf_mop, starts, ac)

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


def phase_wide_quality_f64():
    """The wide path's problem on the card at float64, B=4, max_iter=25,
    under the asserts of tests/test_zdt_quality.py:97-101, beside the JAX
    package's CPU float64 figures for the same starts."""
    from morbit_tpu_torch import AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.problems.synthetic import halton_starts

    mop = wide_mop()
    ac = AlgorithmConfig(max_iter=25, max_evals=1000 * N_WIDE, f_tol_rel=1e-3,
                         x_tol_rel=1e-3)
    t0 = time.perf_counter()
    res = multistart_optimize(mop, halton_starts(4, mop.lb, mop.ub), ac,
                              dtype=torch.float64)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fe, evals = front_error(res.fx).cpu(), res.n_evals.cpu().double()
    phase("wide_quality_f64", B=4, n=N_WIDE, max_iter=25, seconds=seconds,
          trips=res.trips, front_error=fe.tolist(), evals=evals.tolist(),
          front_error_jax_cpu_f64=[0.0, 0.0, 0.017, 0.361],
          evals_jax_cpu_f64=[62, 63, 121, 127],
          stop_codes=res.stop_code.tolist())
    check(bool(torch.isfinite(res.fx).all()), "non-finite fx")
    check(float(fe.min()) < 0.01, f"no start reaches the front: {fe.tolist()}")
    check(float(fe.median()) < 0.5, f"median front error {float(fe.median())} >= 0.5")
    check(float(evals.median()) <= 200, f"median evals {float(evals.median())} > 200")
    check(float(evals.max()) <= 400, f"max evals {float(evals.max())} > 400")


def phase_wide_card_vs_cpu():
    """ZDT1 at n=10 (cubic RBF, float64, B=8, max_iter=10) on the card and on
    the CPU, trip by trip from the same state: the wide instances of K1
    (nv=11, m=22), K2 and K3 (max_points 66) at float64 against the twins'
    run on the CPU."""
    from morbit_tpu_torch import AlgorithmConfig
    from morbit_tpu_torch.models.configs import RbfConfig
    from morbit_tpu_torch.problems.synthetic import halton_starts, make_zdt

    make = lambda: make_zdt("zdt1", 10, model_cfg=RbfConfig(kernel="cubic"))
    mop = make()
    ac = AlgorithmConfig(max_iter=10, max_evals=1000 * 10, f_tol_rel=1e-3,
                         x_tol_rel=1e-3, qp_iters=QP_ITERS)
    trips, seconds, diffs = lockstep(make, halton_starts(8, mop.lb, mop.ub), ac)
    phase("wide_card_vs_cpu", B=8, n=10, dtype="float64", max_iter=10,
          lockstep_trips=trips, lockstep_s=seconds,
          lockstep_rho_max_rel_diff=diffs["rho"], lockstep_fit_max_rel_diff=diffs["fit"])


def gram_work(B, P, n, itemsize):
    """(operations, bytes) of one K4 call: per entry 2n for the cross term
    and ~8 for r^2, phi and the select; the sites and mask read once, the
    (B, P, P) Gram written once."""
    return B * P * P * (2 * n + 8), B * P * n * itemsize + B * P + B * itemsize + B * P * P * itemsize


def phase_kernel_gram(wide_captured):
    """K4 against its twin on the card: B=1024 random cases at (P, n) =
    (134, 14) and (251, 20), all five kernels, B=128 cases at the edges of
    its tiling (P in 128, 129, 251, 512 and n in 1, 20, 32), ~70 % valid
    rows, and the inputs the wide path gave it; max|diff| / max|Phi| within
    1e-12 (float64) or 1e-5 (float32), and the output exactly symmetric.
    Returns the row of the last recorded call."""
    from morbit_tpu_torch.ops import dense_kernels
    from morbit_tpu_torch.ops.rbf import EXPONENT_KERNELS, RBF_KERNELS, kernel_default_param

    def random_set(kernel, P, n, B=B_MAIN):
        def make(dt):
            sites, mask, param = gram_case(np.random.default_rng(P + n), B, P, n)
            f = lambda a: torch.as_tensor(a, dtype=dt, device="cuda")
            par = kernel_default_param(kernel) if kernel in EXPONENT_KERNELS else f(param)
            return f(sites), torch.as_tensor(mask, device="cuda"), kernel, par
        return make

    def recorded(a):
        return lambda dt: (a[0].to(dt), a[1], a[2],
                           a[3].to(dt) if isinstance(a[3], torch.Tensor) else a[3])

    sets = [(f"random_{k}_P{P}_n{n}", random_set(k, P, n))
            for P, n in ((134, 14), (251, N_WIDE)) for k in RBF_KERNELS]
    # the edges of the tiling (P a multiple of 32 and one past it, P = 512,
    # n = 1 and n = 32), each RBF kernel at least once
    edges = [(P, n) for P in (128, 129, 251, 512) for n in (1, N_WIDE, 32)
             if (P, n) != (251, N_WIDE)]
    sets += [(f"edge_{k}_P{P}_n{n}", random_set(k, P, n, B=128))
             for e, (P, n) in enumerate(edges) for k in [RBF_KERNELS[e % len(RBF_KERNELS)]]]
    sets += [(f"wide_path_call{t}", recorded(a))
             for t, (a, _) in zip(WIDE_CAPTURE_CALLS, wide_captured)]
    row = None
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for name, make in sets:
            args = make(dtype)
            before = dense_kernels.gram_launches
            k = dense_kernels.rbf_gram_cuda(*args)
            t, plain_ms = timed(lambda: dense_kernels.rbf_gram_matrix_plain(*args))
            check(dense_kernels.gram_launches == before + 1, "K4 launch not counted")
            err = float((k - t).abs().max()) / float(t.abs().max())
            check(err <= tol, f"K4 {name} {dtype}: max|diff| / max|Phi| = {err} > {tol}")
            # only the tiles with I <= J are computed: the mirror is exact
            check(torch.equal(k, k.transpose(1, 2)), f"K4 {name} {dtype}: not symmetric")
            ms = event_ms(lambda: dense_kernels.rbf_gram_cuda(*args), 10, inner=10)
            B, P, n = args[0].shape
            ops, nbytes = gram_work(B, P, n, args[0].element_size())
            bound_ms, bound_by = bound(ops, nbytes, dtype)
            row = dict(set=name, dtype=str(dtype), B=B, P=P, n=n, kernel=args[2],
                       valid_rows=int(args[1].sum()), max_abs_err=err, tol=tol,
                       symmetric=True, ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       ops=ops, bytes=nbytes)
            phase("kernel_gram", **row)
    return row


def admm_iterations_work(B, n, m, iters, itemsize):
    """(operations, bytes) of one K5 call, counted from the function and not
    from a kernel: per step 2m for t1 = rho zz - y, 2nm for A' t1 and 3n for
    sigma z - q and the sum, 2n^2 for M^-1 rhs, 2mn for A xt, 3n and 10m
    for the updates; the operands read once, z/zz/y written once."""
    ops = B * iters * (2 * m + 2 * n * m + 3 * n + 2 * n * n + 2 * m * n + 3 * n + 10 * m)
    return ops, B * itemsize * (n * n + m * n + 5 * m + 2 * n + n + 2 * m)


#: K5's edge sets beside the timed (3, 6) and (21, 42) sets: (name, n, m, B,
#: iters, rows with infinite bounds); 1023 and 5 are not multiples of the
#: instances a block (4 at (21, 42), 2 at float64 (64, 128))
K5_EDGES = (("n1_m1", 1, 1, 37, 100, False), ("n32_m64", 32, 64, 37, 100, False),
            ("n64_m128", 64, 128, 37, 100, False), ("B1", 21, 42, 1, 100, False),
            ("B1023", 21, 42, 1023, 100, False), ("B5_n64_m128", 64, 128, 5, 30, False),
            ("iters0", 21, 42, 64, 0, False), ("inf_rows", 21, 42, 64, 100, True))


def admm_iterations_edge_case(B, n, m, inf_rows, seed):
    """``admm_iterations_case``; with ``inf_rows`` three rows in four get an
    infinite lower, upper or both bounds (zz0 = clip(0, l, u) again)."""
    Minv, A, rho, q, lo, hi, z0, _, y0 = admm_iterations_case(B, n, m, seed)
    if inf_rows:
        lo[:, 0::4] = -np.inf
        hi[:, 1::4] = np.inf
        lo[:, 2::4], hi[:, 2::4] = -np.inf, np.inf
    return Minv, A, rho, q, lo, hi, z0, np.clip(0.0, lo, hi), y0


def phase_kernel_admm_iterations():
    """K5 against its twin on the card: B=1024, (n, m) = (3, 6) and
    (21, 42), 100 steps, timed over five launches back to back (at (3, 6)
    the wrapper's host time is near the kernel's), then the edge sets
    ``K5_EDGES``; float64 and float32, max|diff| within 1e-10 (float64) or
    1e-4 (float32) times max(1, max|twin|). Returns the float32 rows at
    (3, 6) and (21, 42). No path calls K5."""
    from morbit_tpu_torch.ops import dense_kernels

    timed_sets = [(f"n{n}_m{m}", n, m, B_MAIN, 100, False) for n, m in ((3, 6), (21, 42))]
    rows = {}
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        for (name, n, m, B, iters, inf_rows), is_timed in (
                [(s_, True) for s_ in timed_sets] + [(e, False) for e in K5_EDGES]):
            args = [torch.as_tensor(a, dtype=dtype, device="cuda")
                    for a in admm_iterations_edge_case(B, n, m, inf_rows, seed=n)]
            kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
            before = dense_kernels.admm_iterations_launches
            k = dense_kernels.admm_iterations_cuda(*args, **kw)
            t, plain_ms = timed(lambda: dense_kernels.admm_iterations_plain(*args, **kw))
            check(dense_kernels.admm_iterations_launches == before + 1,
                  "K5 launch not counted")
            err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                      for a, b in zip(k, t))
            check(err <= tol, f"K5 {name} {dtype}: {err} > {tol}")
            row = dict(set=name, n=n, m=m, dtype=str(dtype), B=B, iters=iters,
                       lanes_per_block=dense_kernels.admm_iterations_lanes(
                           n, m, args[0].element_size()),
                       max_abs_err=err, tol=tol, plain_ms=plain_ms)
            if is_timed:
                ms = event_ms(lambda: dense_kernels.admm_iterations_cuda(*args, **kw),
                              10, inner=5)
                ops, nbytes = admm_iterations_work(B, n, m, iters, args[0].element_size())
                bound_ms, bound_by = bound(ops, nbytes, dtype)
                row.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by, ops=ops,
                           bytes=nbytes)
                rows[(name, dtype)] = row
            phase("kernel_admm_iterations", **row)
    return rows[("n3_m6", torch.float32)], rows[("n21_m42", torch.float32)]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    rbf_launches, captured = phase_rbf_main_path()
    wide_launches, wide_captured = phase_wide_main_path(B_WIDE)
    admm_rows = phase_kernel_admm(wide_captured["qp_admm"])
    sel_rows = phase_kernel_selection(captured["selection"], wide_captured["selection"])
    r4_rows = phase_kernel_round4(captured["round4"], wide_captured["round4"])
    gram_row = phase_kernel_gram(wide_captured["gram"])
    k5_rows = phase_kernel_admm_iterations()
    phase_wide_quality_f64()
    phase_wide_card_vs_cpu()
    phase_rbf_card_vs_cpu()
    phase_card_vs_cpu()
    phase_main_path()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # per kernel: its row on the wide path (this slice's path), and for K1-K3
    # also on the RBF main path; K5 has no caller
    rows = [("qp_admm", admm_rows, "morbit_tpu_torch/csrc/qp_admm.cu",
             "morbit_tpu/ops/qp_lane.py:289"),
            ("rbf_selection", sel_rows, "morbit_tpu_torch/csrc/rbf_selection.cu",
             "morbit_tpu/ops/prepare_fused.py:167"),
            ("rbf_round4", r4_rows, "morbit_tpu_torch/csrc/rbf_round4.cu",
             "morbit_tpu/ops/prepare_fused.py:276"),
            ("rbf_gram", (None, gram_row), "morbit_tpu_torch/csrc/rbf_gram.cu",
             "morbit_tpu/ops/pallas_kernels.py:71"),
            ("admm_iterations", (None, k5_rows[1]), "morbit_tpu_torch/csrc/admm_iterations.cu",
             "morbit_tpu/ops/pallas_kernels.py:127")]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    table = []
    for name, (main_row, row), source, replaces in rows:
        check(row is not None and math.isfinite(row["ms"]), f"no row for {name}")
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "path": "wide_main_path" if name in wide_launches else None,
                 "launches": wide_launches.get(name, 0),
                 **{k: row[k] for k in keys}, "library_ms": None}
        if main_row is not None:
            entry["rbf_main_path"] = {"launches": rbf_launches[name],
                                      **{k: main_row[k] for k in keys}}
        if name == "admm_iterations":      # K5's (21, 42) row above; also (3, 6)
            entry["shape"] = [row["n"], row["m"]]
            entry["n3_m6"] = {k: k5_rows[0][k] for k in keys}
        table.append(entry)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
