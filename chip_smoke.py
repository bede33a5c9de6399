"""Chip smoke test of the PyTorch/CUDA port (``morbit_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. ``build``            — nvcc-builds the seven kernels at once, one process
   per source: K1 (``csrc/qp_admm.cu``), K2 (``csrc/rbf_selection.cu``),
   K3 (``csrc/rbf_round4.cu``), K4 (``csrc/rbf_gram.cu``), K5
   (``csrc/admm_iterations.cu``), K6 (``csrc/lane_lu.cu``) and K7
   (``csrc/lane_matmul.cu``); registers, stack and spills per instance.
2. ``rbf_main_path``    — the RBF main path: ``multistart_optimize`` on 1024
   Halton starts of two parabolas, both objectives in one multiquadric RBF
   group, float32, max_iter=100, qp_iters=400; launch counts of K1-K3 in
   the first batch, trips, Pareto-set fraction, the sustained rate. Its
   first batch records the K2/K3 inputs of some trips.
   ``staged_main_path`` — the main path as ``bench.py`` runs it, through
   the bench twin's protocol (``morbit_tpu_torch/bench.py``: probe, probe
   tuning, warm-up, blocked and sustained batches of the tuned
   ``StagedMultistart``) at float32, B=1024, max_iter=10/qp_iters=100 and
   max_iter=100/qp_iters=400, with no plain twin on the card; launches of
   K1-K3 (each at least the trips of all batches), the probe's fill and
   stage capacities, the tuned capacity, schedule and widths, the trips of
   each stage, the overflow flag OR'ed over every batch (must be False),
   the Pareto fraction; then the plain, default staged and tuned runners
   in turns on the same starts (runs/s of each) and the lanes whose stop
   code or iteration count differ between plain and tuned. It records the
   K2/K3 inputs at a stage capacity (22 rows) and a compacted width.
3. ``wide_main_path``   — the wide-n path: ZDT1 at n=20, both objectives in
   one cubic RBF group, the reference grid budget, float32, B_WIDE Halton
   starts; launches of K1-K4 per batch, trips, the front error, evaluations,
   stop codes, database rows, peak memory, the rate. Its first
   batch records the K1-K4 inputs of some calls, and no plain twin may run
   on the card in it. ``wide50_main_path`` — the same at n=50
   (``WIDE50_BUDGET``: max_iter=10, max_evals=1000 n; one sustained batch),
   every kernel past the limits it had before it took every shape: K1's
   strided instance at (51, 102), K2's wide instance, K3's slot instance at
   max_points 1326, K4's tiled instance at P=1326; each at least once a
   trip.
4. ``kernel_admm``, ``kernel_selection``, ``kernel_round4`` — K1, K2, K3
   against their twins on the card, on random cases (the wide shapes
   included: nv=21/m=42, the constrained LPs (3, 8) and (4, 11) with and
   without an equality row (``constrained_lps``), n=20 with 5332 rows, max_points 231 with 2310
   rows; K1 also at (21, 42), (32, 64), (5, 10), (1, 2) with B=1000; K2
   also on lattice sites whose scores tie, with empty lanes and counts past
   the capacity, at n=20 and n=32; K3 also at the block instance's edges,
   ``round4_edge_case``) and the recorded inputs of both paths, float64
   and float32: K1 within 1e-9 (float64) or 2e-3 (float32), on the
   recorded wide LPs and the constrained LPs each lane within the larger of
   that and ten times its own one-ulp sensitivity (``lane_limits``); K2's and K3's
   outputs equal to the twins' on every lane, K2's floats to the bit. K3's
   rows give its bound under the live-size count (``round4_work``) and the
   padded kernel's count, and the tested and accepted candidates per lane.
   Each also holds the n=50 path's recorded call (K2, K3 and K4 against
   the twin's run on its first ``WIDE50_TWIN_LANES`` lanes).
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
   ``kernel_lane_lu``, ``kernel_lane_matmul`` — K6 (LU factor and solve)
   and K7 (lane products), which replace the card's float64 library calls
   whose bits depend on the batch width (ROADMAP 3.15), against their
   twins at float64, equal to the bit: the fits' k (9, 12, 77, 272, 600,
   1,377) with two right-hand sides, the polish's K (9, 11, 63, 153) with
   one, products with 1-3 columns, at B = 1, 16 and 1024 (B = 4 at k =
   1,377); card, twin, bound and library ms (``lu_factor_ex``,
   ``lu_solve``, ``solve_ex``, ``torch.bmm``).
   ``width_invariance_f64`` — under ``kernels_only``, ``width_gaps.py``'s
   float64 problem by the plain runner in shards of 8, 4, 2 and 1 lanes
   (meshes of the card 2-16 times) and by ``StagedMultistart`` with widths
   over a mesh of 4, each equal to the unsharded batch of 16 to the bit in
   every leaf; K6's and K7's launches in those runs.
7. ``wide_quality_f64`` — the wide path's problem at float64, B=4,
   max_iter=25, under the asserts of tests/test_zdt_quality.py:97-101.
8. ``wide_card_vs_cpu`` — ZDT1 at n=10 at float64 on the card and on the
   CPU, trip by trip from the same state. ``wide50_card_vs_cpu`` — ZDT1 at
   n=50, float64, B=4, two trips, the same lockstep; integer leaves equal
   on every lane and trip, and a lane whose floats part is reported with
   its first parting leaf (fault 3.15), not held looser.
9. ``rbf_card_vs_cpu``  — the RBF main path at float64, 64 Halton starts,
   max_iter=100, on the card and on the CPU, trip by trip from the same
   state (integer leaves equal, floats within 1e-9 + 1e-6 |x|), and run
   freely on both (the lanes that end alike; on them x within 1e-9 and fx,
   whose slope is at most 10 on the box, within 1e-8).
   ``staged_card_exact`` — at float64, 64 Halton starts, max_iter=100: the
   probe-tuned runner, a starving width of 1 and ``fleet=False`` each equal
   to the plain runner on the card (``compare_staged``). ``staged_quality_f64``
   — the tuned runner at float64 on 1024 Halton starts, both budgets: equal
   to the plain runner lane by lane, and its Pareto fraction at most 0.01
   below the port's CPU figure (``STAGED_QUALITY_F64``). ``routing`` — K1-K3
   against their twins at B=1 and at float64 B=64.
10. ``card_vs_cpu`` and ``main_path`` — the same two checks with exact
    models (slice 1), at 64 and 1024 starts.
11. ``constrained_main_path`` — the constrained configuration (BASELINE
    config 4: the two parabolas in one multiquadric RBF group, the linear
    row x1 + x2 <= 1 and the exact ball ||x||^2 <= 2.25) at float32,
    B=1024, both budgets: the probe-tuned ``StagedMultistart`` and the
    plain runner in turns, with no plain twin on the card; launches of
    K1-K3 and K1's launches at each LP shape (the descent LP (3, 8), the
    normal-step LP (4, 11)), trips, restoration-loop iterations per trip,
    stop codes, the share of lanes ending feasible, the constrained Pareto
    fraction (a gauge), runs/s and the lanes whose stop code or iteration
    count differ between the runners. It records K1's inputs at both LP
    shapes, which ``kernel_admm`` holds against the twin.
    ``constrained_card_vs_cpu`` — the same problem at float64, 64 Halton
    starts, max_iter=25, on the card and on the CPU, trip by trip from the
    same state (the filter and constraint values included); only the
    recorded pair ``CONSTRAINED_MAY_PART`` may part, on a duplicate site.
12. ``taylor_main_path``, ``lagrange_main_path``, ``ps_main_path`` — the
    main path's problem (two parabolas, 1024 Halton starts from index 1,
    f32, max_iter=100, qp_iters=400) with a degree-2 finite-difference
    ``TaylorConfig`` group, a degree-2 ``LagrangeConfig`` group (both with
    steepest descent), and the main path's multiquadric RBF group with
    ``PascolettiSerafiniConfig()``: the probe-tuned ``StagedMultistart`` and
    the plain runner in turns under ``kernels_only``; runs/s, trips,
    launches per trip, K1 launches (at least one a trip on the Taylor and
    Lagrange paths), K2 and K3 launches (at least one each a trip on the
    PS path), ascent steps per trip, stop codes, database rows and
    ``capacity_overflow`` (must be False), the Pareto fraction (a gauge)
    and the lanes whose stop code or iteration count differ between the
    runners (must be 0). ``taylor_card_vs_cpu``, ``lagrange_card_vs_cpu``,
    ``ps_card_vs_cpu`` — each at float64, 64 starts,
    max_iter=FAMILY_LOCKSTEP_ITERS, card against CPU trip by trip
    (``lockstep``); only the (trip, lane) pairs of ``FAMILY_MAY_PART`` may
    part, each for its recorded cause.
13. ``composite_main_path``, ``scaler_model_main_path``, ``no_db_main_path``
    — the protocol of phase 12 on ``examples/composites.py``'s problem
    (``make_composite``: g(x) = (||x-a||^2, ||x+a||^2), a = (1, 1), in one
    cubic RBF group; the composite objectives g0 and g1 + 0.1 x0 and the
    composite constraint g0 - 9 <= 0; also the feasible share and that the
    one group's counter counts every true call of g), and on the main path
    with ``var_scaler_update='model'`` and with ``use_db=False`` (the fleet
    loop off on both); K1's launches by LP shape. Each records K1's inputs
    at every LP shape but (3, 6) and K2's and K3's inputs, which
    ``kernel_admm``, ``kernel_selection`` and ``kernel_round4`` hold
    against the twins. ``composite_card_vs_cpu``,
    ``scaler_model_card_vs_cpu``, ``no_db_card_vs_cpu`` — phase 12's
    lockstep on these paths. ``optimize_surface`` — ``optimize`` at
    float64 on the card and on the CPU (``_surface_runs``): ``populated_db``
    recycling, ``untransform_final_database`` and recycling its result,
    ``var_scaler='auto'`` without a box, and a checkpoint saved after three
    trips and resumed, equal to the uninterrupted solve to the bit; the
    card's runs equal the CPU's.
14. ``host_main_path``, ``exit_eps_main_path``, ``max_points_main_path`` —
    phase 12's protocol on the main path with both objectives as NumPy
    functions (``host=True, can_batch=True``, one multiquadric group: host
    round trips a trip, rows a round trip, the seconds inside the user's
    functions; the rows passed equal the group's counters; the plain batch
    equal lane by lane to the torch functions' run, x and fx reported to
    the bit, and to a ``can_batch=False`` batch), with
    ``qp_exit_eps=EXIT_EPS`` (K1's stages per lane; K1's exit instance
    recorded at (3, 6)) and with ``RbfConfig(use_max_points=True)`` and
    ``use_db=False`` (56 rows and 60 random candidates: K3 recorded at
    C = 116). ``kernel_admm_exit`` holds K1's exit instance against its
    twin (``phase_kernel_admm_exit``). ``host_card_vs_cpu``,
    ``exit_eps_card_vs_cpu``, ``max_points_card_vs_cpu`` — phase 12's
    lockstep on these paths.
15. ``compacted_main_path`` — the main path's problem at float32, B=1024,
    both budgets of ``STAGED_BUDGETS``: ``CompactedMultistart`` (default
    ladder, ``stage_iters=10``) and the plain runner in turns on distinct
    Halton starts under ``kernels_only``; each pair equal lane by lane in
    stop codes, iterations and evaluations (x and fx differences reported);
    runs/s of both, trips and buckets of each stage, K1-K3 launches a
    batch. ``grid_main_path`` — the benchmark harness
    (``parallel/benchmarks.py``): ``run_benchmarks`` with
    ``steady_state=True`` at float32 over the default grid
    (``generate_all_settings()``: zdt1-3 x n in {2, 5, 10} x {rbf_cubic,
    taylor1, lagrange1, lagrange2}, 8 starts) less ``GRID_CUTS``, and the
    ``GRID_EXTRA`` settings (K4 at n=15 with ``max_iter=20``, DTLZ1,
    staged PS; one ``perform_test`` each); no ``error``
    entry, final stop codes, finite fx and omega; one ``grid_setting`` line
    per setting with its K1-K4 launches; a second call on the save file
    runs nothing. ``compacted_card_exact`` — the compacted runner at
    float64 (``COMPACTED_EXACT``) equal to the plain runner on the card
    leaf by leaf, on the CPU equal to the CPU's plain runner in integers,
    and parting card from CPU on the plain runner's lanes only (ties,
    ROADMAP 3.4). ``grid_card_vs_cpu`` —
    ``perform_test`` at float64 on the card and on the CPU
    (``GRID_CARD_VS_CPU``): integers exact, floats within 1e-10 (the lanes
    of ``GRID_MAY_PART`` within their own bounds, each with the first trip
    a lockstep finds it parting, if any; a lane of ``GRID_PARTINGS`` past
    its bound only where one trip from the CPU's state, its recorded trip
    alone, parts it past 1e-10, in its recorded leaf). ``grid_main_path`` also runs
    ``ZDT2_F32`` (fault 3.14's setting, 8 starts, f32, no steady-state
    call): fx finite on every lane, and omega too but on the lanes of
    ``ZDT2_F32_MAY_NAN``, each of which must end in the recorded state
    from which the JAX package's trip also fits non-finitely (ROADMAP
    3.14).
16. ``parametric_main_path`` — ``parametric_multistart`` on ``build_shifted``
    (the two parabolas centred at +-theta_i, one multiquadric RBF group),
    B=1024, theta_i from ``numpy.random.default_rng`` in [0.5, 2.5]^2,
    Halton starts, float32, max_iter=100, qp_iters=400, under
    ``kernels_only``, with the plain runner on the main path in the same
    call: a warm-up and one timed batch each, runs/s of both, trips, K1-K3
    launches of the parametric warm-up, the share of lanes within 0.3 of
    their own Pareto segment (a gauge). ``parametric_card_vs_cpu`` — the
    same at float64, 64 lanes, max_iter=FAMILY_LOCKSTEP_ITERS, card against
    CPU trip by trip (``lockstep``); no lane may part. ``mesh_main_path`` —
    the main path at float32, B=1024, the reference budget, with the mesh
    ``MESH`` (four shards on one card) against the unsharded run: every
    lane equal to the bit (integers, x and fx); ``StagedMultistart`` with
    the probe-tuned schedule and widths over the mesh (each shard compacts
    its own lanes) against the plain run in integers;
    ``entry.dryrun_multichip(1)``. ``optimize_surface`` also prints the
    live log (``optimize(verbosity=4)``) at float64 on the card and on the
    CPU: the same lines, integers and booleans equal, floats within 1e-10
    relative.

Phases 7-9, ``card_vs_cpu`` and the ``*_card_vs_cpu``, ``optimize_surface``,
``staged_card_exact``, ``staged_quality_f64`` and ``compacted_card_exact``
phases run under ``kernels_only``: no plain twin, and no float64 library solve or product
(``F64_LIBRARY``), runs on a CUDA tensor.

Each phase line carries ``t_s``, the seconds since the script started.
Then the card's name and power limit, one JSON line with the kernel table
(K1-K4 also with the n=50 path's launches and rows, K1-K3 with the
staged main path's launches at each budget, the
``routing`` times, the launches of the paths of phases 12-16, the rows of
the inputs the paths of phases 13-14 recorded and K1's exit instance; K6's
factor and solve and K7 with their launches on the float64 path of
``width_invariance_f64`` and the library call's ms), the script's total
seconds, and as the last line ``{"ok": true, "device": {...}}``. Without CUDA it
exits non-zero before printing any result. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

# one process runs every path, the n=50 path's ~57 GB of fits among them: the
# caching allocator's expandable segments let freed memory serve any later
# size, where fixed segments, split among tensors that still live, left the
# n=50 path's 7.8-15.5 GB temporaries no room (set before torch starts CUDA)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit); float64 is
#: the tensor cores' (DMMA) 67 TFLOP/s, the most the card does at float64
#: (34 outside them): a bound is the least time the card could take
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
B_MAIN = 1024
#: starts per batch of the wide-n path
B_WIDE = 1024
QP_ITERS, ADAPT_EVERY = 400, 100
#: the directory of this script, the repository's root
ROOT = pathlib.Path(__file__).resolve().parent
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
#: sustained batches of the wide path after its first (none: its first
#: batch gives the rate, which keeps the whole script within its time limit
#: beside the n=50 path)
WIDE_SUSTAINED = 0
#: the wide path's budget in this script: the reference grid budget at
#: max_iter=20 (its first 20 iterations), which keeps the script within
#: its time limit beside the n=50 path
WIDE_SMOKE_BUDGET = dict(WIDE_BUDGET, max_iter=20)
#: calls of each kernel whose inputs the wide path's first batch records
WIDE_CAPTURE_CALLS = (2, 10)
#: the n=50 path: ZDT1 at n=50 in one cubic RBF group (max_points 1326, the
#: fit's k = 1326 + 51), float32, the wide path's budget at max_iter=10 and
#: max_evals=1000 n; K1 at (51, 102), K2 at n=50, K3 at (1326, 51, C), K4
#: at P=1326, each past the limits the kernels had before they took every
#: shape
N_WIDE50 = 50
WIDE50_BUDGET = dict(WIDE_BUDGET, max_iter=10, max_evals=1000 * N_WIDE50)
WIDE50_SUSTAINED = 1
WIDE50_CAPTURE_CALLS = (6,)
#: lanes of a recorded n=50 call the K2, K3 and K4 twins run (K3's and K4's
#: (B, 1326, 1326) state does not fit the card at B=1024, and K3's twin
#: took 16.5 s on 32 lanes); the kernel runs all B and is held on these
WIDE50_TWIN_LANES = 8
#: lanes the K2 and K3 twins run on a larger set at n >= N_WIDE (the
#: B=1024 sets at n = 20 and 32; their (B, cap, n, n) and (B, max_points,
#: max_points) temporaries took 3-30 s a set on all 1,024 lanes); the
#: kernel runs all B and is held on these
WIDE_TWIN_LANES = 64
#: K2 and K3 hold the n=50 path's recorded call at its dtype, float32 (their
#: twins took ~40-50 s a dtype there on 32 lanes); both instances are held at float64
#: at n = 50 by tests/test_torch_cuda.py (selection_wide, slots)
#: the script's start, for each phase line's t_s
STARTED = time.perf_counter()


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields,
                      "t_s": round(time.perf_counter() - STARTED, 1)}), flush=True)


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


#: the kinds of ``constrained_lps``
CONSTRAINED_LP_KINDS = ("descent_con", "descent_con_eq", "normal", "normal_eq")


def one_ulp(A, seed):
    """``A`` with each entry moved by about one ulp (a seeded relative
    perturbation of eps): the twin's output on it, against its output on
    ``A``, is the rounding sensitivity that two rounding orders of the same
    computation cannot beat."""
    g = torch.Generator(device=A.device).manual_seed(seed)
    return A * (1 + torch.finfo(A.dtype).eps
                * torch.randn(A.shape, generator=g, device=A.device, dtype=A.dtype))


#: the seeds of the ``one_ulp`` perturbations a lane's sensitivity is taken over
ULP_PROBES = (0, 1)


def lane_list(mask, most=16):
    """The indices of the lanes ``mask`` marks, the first ``most`` of them
    with the count when there are more."""
    idx = torch.nonzero(mask).flatten().tolist()
    return idx if len(idx) <= most else {"count": len(idx), "first": idx[:most]}


def lane_limits(tol, run, A, z, seeds=ULP_PROBES):
    """(B,) each lane's limit for a kernel held against its twin: ``tol``,
    or ten times the lane's own one-ulp sensitivity where that is larger.
    The sensitivity is the largest change of the twin's output ``run(A')``
    against ``z = run(A)`` over the ``one_ulp`` perturbations of A by
    ``seeds``."""
    sens = torch.stack([(run(one_ulp(A, s)) - z).abs().amax(-1) for s in seeds])
    return torch.clamp(10.0 * sens.amax(0), min=tol)


def constrained_lps(B, kind, seed):
    """LPs of the constrained path at random states of two variables on the
    unit box, in OSQP form: the descent LP with two constraint rows
    (nv=3, m=8) or the normal-step LP (4, 11, ``variable_radius`` on half
    the lanes, its ``a >= 0`` row and, elsewhere, its ``del`` row unbounded
    above); with ``kind`` ending in ``_eq`` one of the two rows is an
    equality. Rows are equilibrated, as the solver gives them."""
    from morbit_tpu_torch.core.descent import LinearizedConstraints, descent_lp, normal_lp

    rng = np.random.default_rng(seed)
    n = 2
    p, q = (1, 1) if kind.endswith("_eq") else (0, 2)
    x = rng.uniform(0.2, 0.8, (B, n))
    A_eq, A_ineq = rng.normal(size=(B, p, n)), rng.normal(size=(B, q, n))
    step = rng.uniform(-0.1, 0.1, (B, n))
    b_eq = np.einsum("bpn,bn->bp", A_eq, step)
    b_ineq = np.einsum("bqn,bn->bq", A_ineq, step) + np.abs(rng.normal(size=(B, q)))
    r_eq, r_ineq = np.abs(A_eq).max(-1), np.abs(A_ineq).max(-1)
    t = lambda a: torch.as_tensor(a)
    lin = LinearizedConstraints(t(A_eq / r_eq[..., None]), t(b_eq / r_eq),
                                t(A_ineq / r_ineq[..., None]), t(b_ineq / r_ineq))
    lb, ub = t(np.zeros((B, n))), t(np.ones((B, n)))
    if kind.startswith("descent"):
        arrays = descent_lp(t(x), t(8.0 * rng.normal(size=(B, 2, n))), lb, ub, True, lin)
    else:
        arrays = normal_lp(t(x), lb, ub, lin, 0.7, 0.5, t(rng.uniform(size=B) < 0.5))
    return [a.numpy() for a in arrays]


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
    """Share of lanes strictly within ``tol`` of the two-parabolas Pareto
    set, the segment x1 = x2 in [-1, 1] (the gauge
    ``morbit_tpu_torch/tools/check_convergence.py``, the reference's test)."""
    from morbit_tpu_torch.tools.check_convergence import convergence

    return convergence(x, tol)["convergence"]


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
    (``qp_lane.admm_plan``, ``prepare_fused.selection_plan``)."""
    out, key = {}, None
    for line in log.splitlines():
        hit = re.search(r"(qp_admm_wide|qp_admm_strided|qp_admm|rbf_selection_block|"
                        r"rbf_selection_wide|rbf_selection|rbf_round4_wide|"
                        r"rbf_round4_slots|rbf_round4|rbf_gram_tiled|rbf_gram|admm_iterations|"
                        r"lane_lu_factor|lane_lu_solve|lane_matmul)"
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
    from morbit_tpu_torch.ops import dense_kernels, lane_linalg, prepare_fused, qp_lane

    builds = {"qp_admm": qp_lane.build, "rbf_selection": prepare_fused.build_selection,
              "rbf_round4": prepare_fused.build_round4,
              "rbf_round4_f64": lambda: prepare_fused.build_round4(torch.float64),
              "rbf_gram": dense_kernels.build_gram,
              "admm_iterations": dense_kernels.build_admm_iterations,
              "lane_lu": lane_linalg.build_lu, "lane_matmul": lane_linalg.build_matmul}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:     # one nvcc per source
        done = {k: pool.submit(fn) for k, fn in builds.items()}
        results = {k: f.result() for k, f in done.items()}
    phase("build", seconds=time.perf_counter() - t0,
          libraries={k: str(path.name) for k, (path, _) in results.items()},
          ptxas={k: ptxas_summary(log) for k, (_, log) in results.items()})


#: lanes of K1's recorded float64 sets whose polish jumps between kernel
#: and twin although their stage loops agree within their limits (the n=50
#: path's lanes within their batch's limit): the polish's discontinuity on
#: an LP whose minimizers are not unique, ROADMAP 3.5. Since the float64
#: polish factors with K6, lane 309 jumps too (3.19) and the constrained
#: set's lane 172 no longer does. Each must give two minimizers, equal
#: objectives and both feasible and stationary to the fixed tolerance
POLISH_JUMPS = {"wide50_path_call6": (34, 309)}


def phase_kernel_admm(wide_captured, constrained_captured, option_captured,
                      wide50_captured=()):
    """Kernel vs twin through ``solve_qp`` on random QPs, descent LPs, the
    constrained path's LP shapes (``constrained_lps``) and the LPs the wide,
    the constrained and the composite paths gave the kernel (recorded after
    equilibration, so ``solve_qp`` passes them on unchanged); returns the
    rows of the RBF main path's shape (nv=3 descent LPs, float32), of the
    wide path (its last recorded call, float32), of the constrained
    path's two shapes, of the option paths' recorded shapes (float32) and
    of the n=50 path's recorded call (the strided instance, float32).

    On the recorded wide LPs and on every constrained LP (P = 0, sigma =
    1e-6 or 1e-4 in M = sigma I + A' diag(rho) A, with equality rows at
    rho 1e2-1e3 times the others, 400 steps that leave many lanes
    unconverged) the stage loop amplifies rounding: perturbing A by one ulp
    (``one_ulp``) moves the twin's own output by up to ~1e-7 (float64) or
    ~1e-2 (float32) on some lanes. Two rounding orders of it (kernel and
    twin) cannot agree closer than that, so there the kernel is held to the
    larger of the fixed tolerance and ten times that sensitivity, measured
    in the same run (``lane_limits``): on the wide LPs one limit for the
    batch, from the most sensitive lane; on the constrained LPs each lane's
    own, so that every lane whose twin is not that sensitive meets the
    fixed tolerance, and the lanes held above it are listed. There each
    lane's float64 polish is also held to ten times its own polished
    one-ulp sensitivity, except the lanes named in POLISH_JUMPS, which
    must give two minimizers of their LP."""
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
    sets += [(f"wide50_path_call{c}", a[:5]) for c, (a, _) in zip(WIDE50_CAPTURE_CALLS,
                                                                   wide50_captured)]
    sets += [(kind, constrained_lps(B_MAIN, kind, 40 + i))
             for i, kind in enumerate(CONSTRAINED_LP_KINDS)]
    sets += [(f"constrained_path_{a[2].shape[-1]}_{a[2].shape[-2]}", a[:5])
             for a, _ in constrained_captured]
    sets += [(f"{kind}_path_{a[2].shape[-1]}_{a[2].shape[-2]}", a[:5])
             for kind, cap in option_captured.items() for a, _ in cap["qp_admm"]]
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
            limit = pol_limit = torch.full_like(dz, tol)
            extra = {}
            constrained = kind in CONSTRAINED_LP_KINDS or kind.startswith(
                ("constrained_path", "composite_path"))
            if kind.startswith(("wide_path", "wide50_path")):
                # one limit for the batch, as since the wide path's port:
                # ten times the largest sensitivity under the first probe
                a = t["args"]
                limit = lane_limits(tol, lambda A1: qp_lane.admm_stages_plain(
                    a[0], a[1], A1, *a[3:], **t["kw"])[0], a[2], t["z"], ULP_PROBES[:1])
                limit = pol_limit = torch.full_like(dz, float(limit[ok].max()))
                extra = dict(held_to=float(limit[0]),
                             lanes_within_tol=int((ok & (dz <= tol)).sum()))
            if constrained:
                a = t["args"]
                limit = lane_limits(tol, lambda A1: qp_lane.admm_stages_plain(
                    a[0], a[1], A1, *a[3:], **t["kw"])[0], a[2], t["z"])
                extra = dict(largest_lane_limit=float(limit[ok].max()),
                             lanes_held_above_tol=lane_list(ok & (limit > tol)),
                             lanes_over_tol=lane_list(ok & (dz > tol)))
            if constrained and not f32:
                # the polish's active set is discontinuous on some lanes
                # (ROADMAP 3.5): each lane's polish is held to ten times its
                # own polished one-ulp sensitivity as well
                pol_limit = torch.maximum(limit, lane_limits(
                    tol, lambda A1: through_solve_qp(qp_lane.admm_stages_plain, P, q, A1,
                                                     lo, hi)[0].z, A, sol_p.z))
                extra.update(polished_largest_lane_limit=float(pol_limit[ok].max()),
                             polished_lanes_held_above_tol=lane_list(ok & (pol_limit > tol)))
            row = admm_row(k["args"], k["kw"], dtype, t["ms"], set=kind,
                           ok_lanes=int(ok.sum()), max_abs_err=err, tol=tol, **extra,
                           polished_max_abs_err=pol_err,
                           polished_lanes_over_tol=int((ok & (dz_pol > tol)).sum()))
            phase("kernel_admm", **row)
            over = ok & (dz > limit)
            check(not over.any(), f"{kind} nv={nv} m={m} {dtype}: lanes "
                  f"{lane_list(over)} over their limits, |dz| {dz[over].tolist()[:16]} > "
                  f"{limit[over].tolist()[:16]}")
            if not f32:
                over = ok & (dz_pol > pol_limit)
                for i in POLISH_JUMPS.get(kind, ()):
                    # another minimizer of the same LP: equal objective,
                    # both feasible and stationary to the fixed tolerance
                    both = dict(obj=[float(sol_k.obj[i]), float(sol_p.obj[i])],
                                prim_res=[float(sol_k.prim_res[i]), float(sol_p.prim_res[i])],
                                dual_res=[float(sol_k.dual_res[i]), float(sol_p.dual_res[i])])
                    phase("kernel_admm_polish_jump", set=kind, dtype=str(dtype), lane=i,
                          abs_err=float(dz_pol[i]), own_limit=float(pol_limit[i]), **both)
                    check(abs(both["obj"][0] - both["obj"][1]) <= tol
                          and max(both["prim_res"] + both["dual_res"]) <= tol,
                          f"{kind} {dtype}: lane {i}'s two polished points are not both "
                          f"minimizers: {both}")
                    over[i] = False
                check(not over.any(), f"{kind} nv={nv} m={m} {dtype}: polished lanes "
                      f"{lane_list(over)} over their limits, |dz| "
                      f"{dz_pol[over].tolist()[:16]} > {pol_limit[over].tolist()[:16]}")
            rows[(kind, nv, dtype)] = row
    wide = [v for (kind, _, dt), v in rows.items()
            if kind.startswith("wide_path") and dt == torch.float32]
    constrained = {f"nv{v['nv']}_m{v['m']}": v for (kind, _, dt), v in rows.items()
                   if kind.startswith("constrained_path") and dt == torch.float32}
    options = {kind: {f"nv{v['nv']}_m{v['m']}": v for (name, _, dt), v in rows.items()
                      if name.startswith(kind + "_path") and dt == torch.float32}
               for kind in option_captured}
    wide50 = [v for (kind, _, dt), v in rows.items()
              if kind.startswith("wide50_path") and dt == torch.float32]
    return (rows[("descent", 3, torch.float32)], wide[-1], constrained, options,
            wide50[-1] if wide50 else None)


def ten_ulps(A, seed):
    """``A`` with each entry moved by about ten ulps (``one_ulp`` scaled)."""
    g = torch.Generator(device=A.device).manual_seed(seed)
    return A * (1 + 10 * torch.finfo(A.dtype).eps
                * torch.randn(A.shape, generator=g, device=A.device, dtype=A.dtype))


#: the rounding allowance of ``exit_straddles``, in units of the dtype's
#: eps times the magnitude of the residuals' terms
STRADDLE_ULPS = 16


def exit_straddles(args, kw, k_stages, t_stages, lanes, report=None):
    """(B,) bool: the lanes of ``lanes`` where kernel and twin stopped at
    different stages because each followed its own residual: at the first
    stage s where only one of them stops, the exit tolerance lies between
    the kernel's and the twin's residual max(pr, dr) after s fixed-trip
    stages, recomputed in float64 from their (z, zz, y), up to the rounding
    of a residual in the run's dtype (STRADDLE_ULPS eps times the largest
    magnitude of its terms, |A||z| + |zz| and |P||z| + |q| + |A'||y|). At
    float32 the kernel and its twin round differently (an explicit M^-1
    against a Cholesky solve; ``kernel_admm`` holds their z to 2e-3), so a
    lane whose residual is within rounding of the tolerance may stop a
    stage apart. ``report`` (a list) gets each tested lane's residuals."""
    from morbit_tpu_torch.ops import qp_lane

    P, q, A, lo, hi, rho0 = args
    fixed = {x: kw[x] for x in kw if x != "exit_eps"}
    eps = kw["exit_eps"]
    ulp = STRADDLE_ULPS * torch.finfo(q.dtype).eps
    s_min = torch.minimum(k_stages, t_stages)
    out = torch.zeros_like(lanes)
    d = lambda t: t.double()
    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)
    for s in set(s_min[lanes].tolist()):
        res, slack = [], []
        for run in (qp_lane.admm_stages_cuda, qp_lane.admm_stages_plain):
            z, zz, y = (d(t) for t in run(P, q, A, lo, hi, rho0, **{**fixed, "n_stages": s}))
            A64, P64, At = d(A), d(P), d(A).transpose(-1, -2)
            pr = (mv(A64, z) - zz).abs().amax(-1)
            dr = (mv(P64, z) + d(q) + mv(At, y)).abs().amax(-1)
            term = torch.maximum(
                (mv(A64.abs(), z.abs()) + zz.abs()).amax(-1),
                (mv(P64.abs(), z.abs()) + d(q).abs() + mv(At.abs(), y.abs())).amax(-1))
            res.append(torch.maximum(pr, dr).cpu())
            slack.append((ulp * term).cpu())
        lo_r = torch.minimum(res[0] - slack[0], res[1] - slack[1])
        hi_r = torch.maximum(res[0] + slack[0], res[1] + slack[1])
        here = lanes & (s_min == s)
        out |= here & (lo_r <= eps) & (hi_r >= eps)
        if report is not None:
            report += [dict(lane=int(i), stage=s, kernel=float(res[0][i]), twin=float(res[1][i]),
                            slack=float(max(slack[0][i], slack[1][i])))
                       for i in here.nonzero().flatten().tolist()[:8]]
    return out


def phase_kernel_admm_exit(exit_captured):
    """K1's exit instance (``qp_exit_eps``) against its twin through
    ``solve_qp(exit_eps=EXIT_EPS)`` on random QPs and LPs at (3, 6), (4, 8)
    and (21, 42) and on the (3, 6) LPs the exit_eps path recorded, float64
    and float32. Each lane must run the twin's count of stages, unless the
    twin's own decision is within ten ulps (a lane whose twin stops at
    another stage when A moves by ten ulps, ``ten_ulps``, the probes of
    ``ULP_PROBES``) or, at float32, the tolerance lies between the two
    implementations' own residuals at the stage where they part
    (``exit_straddles``); such lanes are listed. z is held as in
    ``kernel_admm``: within the larger of the fixed tolerance and ten times
    the lane's own one-ulp sensitivity (``lane_limits``), a parted lane
    against the twin's fixed-trip loop at the kernel's count of stages.
    The exit instance with an exit_eps below every residual equals the
    fixed-trip instance to the bit. Returns the float32 row of the recorded
    set (its time beside the fixed-trip instance's on the same LPs, the
    stages per lane and the bound on the stages run)."""
    from morbit_tpu_torch.ops import qp_lane
    from morbit_tpu_torch.ops.qp import solve_qp

    def through(stages, P, q, A, lo, hi):
        seen = {}

        def wrapped(*args, **kw):
            seen["args"], seen["kw"] = args, kw
            out, seen["ms"] = timed(lambda: stages(*args, **kw))
            seen["z"], seen["stages"] = out[0], out[3].cpu()
            return out
        with mock.patch.object(qp_lane, "admm_stages_exit", wrapped):
            sol = solve_qp(P, q, A, lo, hi, iters=QP_ITERS, adapt_every=ADAPT_EVERY,
                           exit_eps=EXIT_EPS)
        return sol, seen

    sets = [("random", random_qps(B_MAIN, 3, 6, 0)), ("descent", descent_lps(B_MAIN, 2)),
            ("random", random_qps(B_MAIN, 4, 8, 1)),
            ("random_B1000", random_qps(1000, 21, 42, 5))]
    sets += [("exit_eps_path_3_6", a[:5]) for a, _ in exit_captured]
    out = None
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 2e-3)):
        for kind, arrays in sets:
            P, q, A, lo, hi = (torch.as_tensor(a, dtype=dtype, device="cuda") for a in arrays)
            nv, m = A.shape[-1], A.shape[-2]
            qp_lane.launches = 0
            sol_k, k = through(qp_lane.admm_stages_exit_cuda, P, q, A, lo, hi)
            check(qp_lane.launches == 1, f"kernel launches {qp_lane.launches} != 1")
            sol_p, t = through(qp_lane.admm_stages_exit_plain, P, q, A, lo, hi)
            a, kw = t["args"], t["kw"]
            twin = lambda A1: qp_lane.admm_stages_exit_plain(a[0], a[1], A1, *a[3:], **kw)
            sensitive = torch.zeros_like(t["stages"], dtype=torch.bool)
            for seed in ULP_PROBES:
                sensitive |= twin(ten_ulps(a[2], seed))[3].cpu() != t["stages"]
            parted = k["stages"] != t["stages"]
            straddle, residuals = torch.zeros_like(parted), []
            if dtype == torch.float32:
                straddle = exit_straddles(a, kw, k["stages"], t["stages"],
                                          parted & ~sensitive, residuals)
            check(not (parted & ~sensitive & ~straddle).any(),
                  f"exit {kind} nv={nv} m={m} {dtype}: lanes "
                  f"{lane_list(parted & ~sensitive & ~straddle)} run another count of stages "
                  f"than the twin; residuals {residuals}")
            ok = sol_p.status_ok
            status = (sol_k.status_ok != ok).cpu() & ~parted
            check(not status.any(), f"exit {kind} {dtype}: status_ok differs on lanes "
                  f"{lane_list(status)}")
            dz = (k["z"] - t["z"]).abs().amax(-1).cpu()
            limit = lane_limits(tol, lambda A1: twin(A1)[0], a[2], t["z"]).cpu()
            ref = t["z"].clone()
            for s_ in set(k["stages"][parted].tolist()):
                lanes = (parted & (k["stages"] == s_)).to(ref.device)
                fixed = qp_lane.admm_stages_plain(*a, **{**{x: kw[x] for x in kw
                                                             if x != "exit_eps"},
                                                          "n_stages": s_})[0]
                ref = torch.where(lanes[:, None], fixed, ref)
            dz = torch.where(parted, (k["z"] - ref).abs().amax(-1).cpu(), dz)
            okc = ok.cpu()
            over = okc & (dz > limit)
            check(not over.any(), f"exit {kind} nv={nv} m={m} {dtype}: lanes "
                  f"{lane_list(over)} over their limits, |dz| {dz[over].tolist()[:16]}")
            # below every residual no lane stops: the fixed-trip arithmetic
            full = qp_lane.admm_stages_exit_cuda(*a, **{**kw, "exit_eps": 1e-300})
            fixed = qp_lane.admm_stages_cuda(*a, **{x: kw[x] for x in kw if x != "exit_eps"})
            ran_all = (full[3] == kw["n_stages"])
            bitwise = all(bool((x[ran_all] == y[ran_all]).all()) for x, y in zip(full, fixed))
            check(bitwise and int(ran_all.sum()) > 0,
                  f"exit {kind} {dtype}: the exit instance below every residual differs "
                  "from the fixed-trip instance")
            hist = torch.bincount(k["stages"].long(), minlength=kw["n_stages"] + 1).tolist()
            ms = event_ms(lambda: qp_lane.admm_stages_exit_cuda(*a, **kw), 20)
            fixed_ms = event_ms(lambda: qp_lane.admm_stages_cuda(
                *a, **{x: kw[x] for x in kw if x != "exit_eps"}), 20)
            B = A.shape[0]
            flops = sum(c * admm_flops(nv, m, s_, kw["n_steps"]) for s_, c in enumerate(hist))
            nbytes = B * admm_bytes(nv, m, A.element_size())
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            row = dict(set=kind, nv=nv, m=m, dtype=str(dtype), B=B, exit_eps=EXIT_EPS,
                       stages_per_lane_hist=hist, lanes_parted=lane_list(parted),
                       lanes_decision_within_ten_ulps=int(sensitive.sum()),
                       lanes_parted_on_own_residuals=int(straddle.sum()),
                       max_abs_err=float(dz[okc].max()) if okc.any() else 0.0, tol=tol,
                       largest_lane_limit=float(limit[okc].max()) if okc.any() else tol,
                       ms=ms, fixed_trip_ms=fixed_ms, plain_ms=t["ms"], bound_ms=bound_ms,
                       bound_by=bound_by, flops_stages_run=flops, bytes=nbytes,
                       below_every_residual_bitwise_fixed=bitwise)
            phase("kernel_admm_exit", **row)
            if kind == "exit_eps_path_3_6" and dtype == torch.float32:
                out = row
    check(out is not None, "no recorded exit_eps LPs")
    return out


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
    from morbit_tpu_torch import AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.problems.synthetic import halton_starts

    mop = rbf_mop()
    ac = AlgorithmConfig(max_iter=100, qp_iters=QP_ITERS)
    starts = [torch.as_tensor(halton_starts(B_MAIN, LB, UB, 1 + k * B_MAIN),
                              dtype=torch.float32, device="cuda")
              for k in range(5)]
    captured = {"selection": [], "round4": []}
    torch.cuda.synchronize()
    _zero_launch_counts()
    t0 = time.perf_counter()
    with kernels_only(), recording(captured, CAPTURE_TRIPS):
        res = multistart_optimize(mop, starts[0], ac, dtype=torch.float32)
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _launch_counts()
    for name, count in launches.items():
        check(count >= res.trips, f"{name} launched {count} times in {res.trips} trips")
    _check_result(res, B_MAIN)

    # sustained protocol: back-to-back batches on distinct pre-staged starts
    t0 = time.perf_counter()
    trips = [multistart_optimize(mop, x0, ac, dtype=torch.float32).trips
             for x0 in starts[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    phase("rbf_main_path", B=B_MAIN, dtype="float32", max_iter=100, qp_iters=QP_ITERS,
          model="RbfConfig(kernel='multiquadric')", launches=launches, trips=res.trips,
          first_batch_s=first_s, runs_per_s=len(trips) * B_MAIN / dt,
          sustained_batches=len(trips), sustained_s=dt, trips_sustained=trips,
          pareto_fraction_1e2=pareto_fraction(res.x),
          pareto_fraction_1e2_jax_cpu_f32=0.315,
          mean_iterations=float(res.n_iterations.double().mean()),
          mean_evals=float(res.n_evals.double().mean()), stop_codes=_stop_codes(res),
          db_capacity=int(res.state.groups[0].db.data.shape[1]))
    return launches, captured


#: the staged main path's budgets: ``bench.py``'s headline and its
#: reference-default point
STAGED_BUDGETS = (dict(max_iter=10, qp_iters=100), dict(max_iter=100, qp_iters=QP_ITERS))
#: sustained batches of the bench protocol per budget in ``staged_main_path``
STAGED_REPS = (2, 1)
#: interleaved rounds of the plain, default staged and tuned runners
STAGED_ROUNDS = 1
#: the port's plain runner on the CPU at float64, fraction of 1024 Halton
#: starts within 1e-2 of the Pareto set, by budget
#: (``python3 -m morbit_tpu_torch.tools.check_convergence 10 100 --device cpu
#: --dtype f64``, and ``100 400``)
STAGED_QUALITY_F64 = {10: 0.4296875, 100: 0.7705078125}
#: the JAX package's figures at the same budgets, for context only: jitted
#: on the CPU at float64 (``tools/check_convergence.py``, ``quality_r5.json``)
#: and, at max_iter=10, the port's CPU float64 run from JAX's jitted initial
#: state
JAX_QUALITY_F64 = {10: {"jax_cpu_f64": 0.384, "port_cpu_f64_from_jax_initial_state": 0.3877},
                   100: {"jax_cpu_f64": 0.784}}


def _launch_counts():
    from morbit_tpu_torch.ops import prepare_fused, qp_lane

    return {"qp_admm": qp_lane.launches, "rbf_selection": prepare_fused.selection_launches,
            "rbf_round4": prepare_fused.round4_launches}


def _zero_launch_counts():
    from morbit_tpu_torch.ops import prepare_fused, qp_lane

    qp_lane.launches = prepare_fused.selection_launches = prepare_fused.round4_launches = 0


def _all_launch_counts():
    """K1-K4's launch counts (K4 runs where an RBF fits P >= 128 sites)."""
    from morbit_tpu_torch.ops import dense_kernels

    return {**_launch_counts(), "rbf_gram": dense_kernels.gram_launches}


def _zero_all_launch_counts():
    from morbit_tpu_torch.ops import dense_kernels

    _zero_launch_counts()
    dense_kernels.gram_launches = 0


def stage_shapes(B):
    """A ``recording`` predicate: the first K2/K3 call at the smallest stage
    capacity of the main path (22 rows at one iteration) and the first at
    a compacted width (fewer than ``B`` lanes)."""
    seen = set()

    def keep(name, call, args):
        lanes, rows = args[0].shape[:2]
        kind = "cap22" if rows == 22 else ("compacted" if lanes < B else None)
        if kind is None or (name, kind) in seen:
            return False
        seen.add((name, kind))
        return True
    return keep


def _stop_codes(res):
    from morbit_tpu_torch import STOP_CODE

    return {STOP_CODE(c).name: int((res.stop_code == c).sum()) for c in range(2, 7)}


def _check_result(res, B):
    from morbit_tpu_torch import STOP_CODE

    check(bool(((res.stop_code >= STOP_CODE.MAX_ITER)
                & (res.stop_code <= STOP_CODE.INFEASIBLE)).all()), "invalid stop code")
    check(bool(torch.isfinite(res.x).all() and torch.isfinite(res.fx).all()),
          "non-finite x or fx")
    check(tuple(res.x.shape) == (B, 2), f"x has shape {tuple(res.x.shape)}")


def phase_staged_main_path():
    """The main path as ``bench.py`` runs it, through the bench twin's
    protocol (``morbit_tpu_torch.bench.run_point``) at float32, B=1024, both
    budgets: probe, tuning, warm-up, one blocked batch and sustained
    batches. The counts are set to 0 just before each budget's protocol and
    read just after it, under ``kernels_only``; the runs record the K2/K3
    inputs of ``stage_shapes``. Then the plain, default staged and tuned
    runners in turns on the same starts, and the lanes whose stop code or
    iteration count differ between plain and tuned. Returns the launches
    of each budget and the recorded inputs."""
    from morbit_tpu_torch import AlgorithmConfig, StagedMultistart, multistart_optimize
    from morbit_tpu_torch.bench import run_point
    from morbit_tpu_torch.problems.synthetic import halton_starts

    cuda = torch.device("cuda")
    captured = {"selection": [], "round4": []}
    keep = stage_shapes(B_MAIN)
    launches = []
    for budget, n_rep in zip(STAGED_BUDGETS, STAGED_REPS):
        torch.cuda.synchronize()
        _zero_launch_counts()
        t0 = time.perf_counter()
        with kernels_only(), recording(captured, keep):
            point = run_point(budget, B_MAIN, n_rep, torch.float32, cuda)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
        batches = point["batches"]
        trips = sum(r.trips for r in batches)
        for name, count in counts.items():
            check(count >= trips, f"{name} launched {count} times in {trips} staged trips")
        check(not point["overflow"], "a staged batch overflowed its database")
        # the warm-up ran on Halton starts from index 1, the gauge's fleet
        probe, fleet, res = batches[0], batches[1], batches[-1]
        for r in batches:
            _check_result(r, B_MAIN)
        runner = point["runner"]
        mop, ac = runner.solver.mop, AlgorithmConfig(**budget)
        default = StagedMultistart(mop, ac, torch.float32)

        # plain, default staged and tuned in turns on distinct starts
        rates = {"plain": [], "staged_default": [], "tuned": []}
        flips = None
        for k in range(STAGED_ROUNDS):
            x0 = torch.as_tensor(halton_starts(B_MAIN, LB, UB, 1 + (k + 1) * B_MAIN),
                                 dtype=torch.float32, device=cuda)
            out = {}
            for name, run in (("plain", lambda x: multistart_optimize(mop, x, ac)),
                              ("staged_default", default), ("tuned", runner)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[name] = run(x0)
                torch.cuda.synchronize()
                rates[name].append(time.perf_counter() - t0)
            if flips is None:
                p, t = out["plain"], out["tuned"]
                flips = int(((p.stop_code != t.stop_code)
                             | (p.n_iterations != t.n_iterations)).sum())
        phase("staged_main_path", B=B_MAIN, dtype="float32", **budget,
              model="RbfConfig(kernel='multiquadric')", launches=counts,
              trips_all_batches=trips, batches=len(batches), seconds=seconds,
              probe_trips=probe.trips, probe_stage_trips=list(probe.stage_trips),
              probe_schedule=[t for t, _ in default.schedule],
              probe_stage_capacities=[c for _, c in default.schedule],
              probe_db_fill=max(int(g.db.count.max()) for g in probe.state.groups),
              default_db_capacity=default.solver.db_capacity,
              db_capacity=runner.solver.db_capacity,
              schedule=[t for t, _ in runner.schedule],
              stage_capacities=[c for _, c in runner.schedule],
              widths=list(runner.widths), trips=res.trips,
              stage_trips=list(res.stage_trips),
              stage_trips_sustained=[list(r.stage_trips) for r in batches[3:]],
              capacity_overflow=point["overflow"],
              runs_per_s=point["runs_per_sec"],
              blocked_latency_ms=point["blocked_latency_s"] * 1e3,
              setup_s=point["setup_s"],
              interleaved_runs_per_s={k: len(v) * B_MAIN / sum(v) for k, v in rates.items()},
              interleaved_batch_s=rates, lanes_differing_plain_vs_tuned=flips,
              pareto_fraction_1e2=pareto_fraction(fleet.x),
              pareto_fraction_1e2_jax_cpu_f32=0.315 if budget["max_iter"] == 100 else 0.234,
              mean_iterations=float(fleet.n_iterations.double().mean()),
              stop_codes=_stop_codes(fleet))
        launches.append(counts)
    check(len(captured["selection"]) == 2 and len(captured["round4"]) == 2,
          f"recorded {len(captured['selection'])} K2 and {len(captured['round4'])} "
          "K3 calls at the stage shapes, expected 2 each")
    return launches, captured


def _canonical(res, cap):
    """The canonical state of a result (``canonicalize_buffer_tails``),
    its databases at ``cap`` rows (the zero rows past every fill count
    dropped or added)."""
    from morbit_tpu_torch.parallel.multistart import (_resize_dbs,
                                                      canonicalize_buffer_tails)

    return _resize_dbs(canonicalize_buffer_tails(res.state), cap)


def compare_staged(res, ref):
    """A staged result against the plain runner's, lane by lane, after
    ``canonicalize_buffer_tails``: integer leaves equal (stop codes,
    iterations, evaluations, fill counts), floats within 1e-9 + 1e-6 |x|
    (``_compare_states``). Returns the reported relative differences."""
    cap = res.state.groups[0].db.data.shape[1]
    for name in ("stop_code", "n_iterations", "n_evals"):
        check(bool(torch.equal(getattr(res, name), getattr(ref, name))), f"{name} differs")
    return _compare_states(_canonical(res, cap), _canonical(ref, cap))[0]


def phase_staged_card_exact():
    """On the card at float64, B=64 Halton starts, max_iter=100: the tuned
    runner (probe protocol), a starving ``widths`` (width 1 in the second
    stage) and ``fleet=False`` each against the plain runner
    (``compare_staged``)."""
    from morbit_tpu_torch import AlgorithmConfig, StagedMultistart, multistart_optimize
    from morbit_tpu_torch.bench import tuned_runner
    from morbit_tpu_torch.problems.synthetic import halton_starts

    B, mop = 64, rbf_mop()
    ac = AlgorithmConfig(max_iter=100, qp_iters=QP_ITERS)
    x0 = torch.as_tensor(halton_starts(B, LB, UB), dtype=torch.float64, device="cuda")
    t0 = time.perf_counter()
    ref = multistart_optimize(mop, x0, ac, dtype=torch.float64)
    tuned, _ = tuned_runner(mop, ac, torch.float64, torch.device("cuda"), x0)
    runners = {"tuned": tuned,
               "starving_widths": StagedMultistart(mop, ac, torch.float64, schedule=(3, 6),
                                                   widths=(B, 1)),
               "fleet_off": StagedMultistart(mop, ac, torch.float64, fleet=False)}
    rows = {}
    for name, run in runners.items():
        res = run(x0)
        diffs = compare_staged(res, ref)
        rows[name] = dict(schedule=[t for t, _ in run.schedule], widths=run.widths,
                          fleet=run.fleet, db_capacity=run.solver.db_capacity,
                          trips=res.trips, stage_trips=list(res.stage_trips),
                          rho_max_rel_diff=diffs["rho"], fit_max_rel_diff=diffs["fit"])
    phase("staged_card_exact", B=B, dtype="float64", max_iter=100, plain_trips=ref.trips,
          runners=rows, seconds=time.perf_counter() - t0)


def phase_staged_quality_f64():
    """The tuned runner on the card at float64, 1024 Halton starts from
    index 1, both budgets, against the plain runner on the card (stop codes,
    iterations and evaluations equal lane by lane) and against the port's
    CPU float64 plain-runner figure (STAGED_QUALITY_F64): the fraction
    within 1e-2 of the Pareto set at most 0.01 below it. Card and CPU part
    on about a tenth of the lanes at this size (last-bit differences of the
    plain PyTorch operations, decided by exact ties; the card's run with
    every kernel replaced by its twin lands where the kernels' run does), so
    the figure is printed beside the CPU's with their difference, beside the
    plain runner's on the starts times 1 + eps (moved by one or two ulps:
    the figure's own rounding sensitivity) and beside the JAX package's
    figures."""
    from morbit_tpu_torch import AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.bench import tuned_runner
    from morbit_tpu_torch.parallel.multistart import capacity_overflowed
    from morbit_tpu_torch.problems.synthetic import halton_starts
    from morbit_tpu_torch.tools.check_convergence import convergence

    x0 = torch.as_tensor(halton_starts(B_MAIN, LB, UB), dtype=torch.float64, device="cuda")
    x0_ulp = x0 * (1 + torch.finfo(torch.float64).eps)
    for budget in STAGED_BUDGETS:
        ac = AlgorithmConfig(**budget)
        t0 = time.perf_counter()
        plain = multistart_optimize(rbf_mop(), x0, ac, dtype=torch.float64)
        runner, probe = tuned_runner(rbf_mop(), ac, torch.float64, torch.device("cuda"), x0)
        res = runner(x0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(not (capacity_overflowed(probe) or capacity_overflowed(res)),
              "the f64 tuned run overflowed its database")
        for name in ("stop_code", "n_iterations", "n_evals"):
            check(bool(torch.equal(getattr(res, name), getattr(plain, name))),
                  f"f64 tuned vs plain at B={B_MAIN}: {name} differs")
        gauge = convergence(res.x)
        want = STAGED_QUALITY_F64[budget["max_iter"]]
        shifted = multistart_optimize(rbf_mop(), x0_ulp, ac, dtype=torch.float64)
        phase("staged_quality_f64", B=B_MAIN, **budget, **gauge,
              plain_runner_convergence=convergence(plain.x)["convergence"],
              tuned_vs_plain_max_abs_dx=float((res.x - plain.x).abs().max()),
              plain_runner_convergence_starts_times_1_plus_eps=convergence(
                  shifted.x)["convergence"],
              port_cpu_f64_plain=want, minus_port_cpu_f64_plain=gauge["convergence"] - want,
              **JAX_QUALITY_F64[budget["max_iter"]],
              db_capacity=runner.solver.db_capacity, trips=res.trips,
              stage_trips=list(res.stage_trips), seconds=seconds)
        check(gauge["convergence"] >= want - 0.01,
              f"f64 Pareto fraction {gauge['convergence']} is more than 0.01 below {want}")


def phase_routing():
    """Kernel against twin at the shapes that the routing rule of the north
    star would send to the twin: B=1 (``optimize``) at float64 and float32,
    and B=64 at float64 (``card_vs_cpu``), at the main path's K1 (nv=3,
    m=6, 400 steps), K2 (n=2, 1507 rows) and K3 ((6, 3, 60)) shapes; card
    ms of each (median of event timings) by name and case."""
    from morbit_tpu_torch.models.rbf_round4 import run_round4
    from morbit_tpu_torch.ops import prepare_fused, qp_lane
    from morbit_tpu_torch.ops.prepare_coord import rbf_selection_core
    from morbit_tpu_torch.ops.qp import _rho_vec

    out = {"qp_admm": {}, "rbf_selection": {}, "rbf_round4": {}}
    for B, dtype in ((1, torch.float64), (1, torch.float32), (64, torch.float64)):
        case = f"B{B}_{'f64' if dtype == torch.float64 else 'f32'}"
        f = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
        P, q, A, lo, hi = (f(a) for a in random_qps(B, 3, 6, 0))
        f32 = dtype == torch.float32
        kw = dict(n_stages=4, n_steps=100, sigma=1e-4 if f32 else 1e-6, alpha=1.6,
                  rho_lo=1e-3 if f32 else 1e-6, rho_hi=1e4 if f32 else 1e6)
        qp = (P, q, A, lo, hi, _rho_vec(lo, hi, 0.1))
        sel = _selection_tensors(selection_case(np.random.default_rng(5), B, 1507, 2,
                                                "mixed"), dtype)
        X, cand, init, count, param = round4_case(np.random.default_rng(6), B, 60, 2, 6, 0.4)
        r4 = (f(X), torch.as_tensor(cand, device="cuda"), f(init),
              torch.as_tensor(count, dtype=torch.int32, device="cuda"))
        r4_kw = dict(kernel="multiquadric", param=f(param), poly_deg=1, max_points=6,
                     chol_pivot=0.1)
        pairs = {"qp_admm": (lambda: qp_lane.admm_stages_cuda(*qp, **kw),
                             lambda: qp_lane.admm_stages_plain(*qp, **kw)),
                 "rbf_selection": (lambda: prepare_fused.selection_cuda(*sel, **SEL_STATICS),
                                   lambda: rbf_selection_core(*sel, **SEL_STATICS)),
                 "rbf_round4": (lambda: prepare_fused.round4_cuda(*r4, **r4_kw),
                                lambda: run_round4(*r4, **r4_kw))}
        for name, (kernel, twin) in pairs.items():
            out[name][case] = {"ms": event_ms(kernel, 20), "plain_ms": event_ms(twin, 5)}
    phase("routing", **out)
    return out


#: the wrappers whose inputs a path records, by the name of their captures
_RECORDED = {"qp_admm": ("qp_lane", "admm_stages"),
             "qp_admm_exit": ("qp_lane", "admm_stages_exit"),
             "selection": ("prepare_fused", "selection"),
             "round4": ("prepare_fused", "round4"),
             "gram": ("dense_kernels", "rbf_gram_matrix")}


@contextlib.contextmanager
def recording(captured, calls_to_keep):
    """Record copies of the inputs of the wrappers named in ``captured``
    (a dict of empty lists) at the call numbers in ``calls_to_keep``, or
    where ``calls_to_keep(name, call_number, args)`` is true; the copies are
    made outside the kernels and launch none."""
    from morbit_tpu_torch.ops import dense_kernels, prepare_fused, qp_lane

    mods = {"qp_lane": qp_lane, "prepare_fused": prepare_fused,
            "dense_kernels": dense_kernels}
    calls = dict.fromkeys(captured, 0)
    keep = (calls_to_keep if callable(calls_to_keep)
            else lambda name, i, args: i in calls_to_keep)

    def wrap(name, fn):
        def wrapped(*args, **kw):
            if keep(name, calls[name], args):
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


#: the library calls whose float64 results on the card depend on the batch
#: width (ROADMAP 3.15): K6 and K7 take their place on every float64 CUDA
#: tensor, and ``kernels_only`` makes them raise there
F64_LIBRARY = ((torch.linalg, "solve_ex"), (torch.linalg, "solve"),
               (torch.linalg, "lu_factor_ex"), (torch.linalg, "lu_factor"),
               (torch.linalg, "lu_solve"), (torch, "matmul"), (torch, "bmm"),
               (torch, "einsum"), (torch.Tensor, "__matmul__"))


def _tensors(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from _tensors(a)
        elif isinstance(a, torch.Tensor):
            yield a


@contextlib.contextmanager
def kernels_only():
    """Make every plain twin raise on a CUDA tensor, and every library call
    of ``F64_LIBRARY`` on a float64 CUDA tensor, so that a run shows it went
    through the kernels only (K6 and K7 for its float64 solves and
    products). The one float64 library product left is ``lane_matmul``'s
    float32 branch (``batched_linalg._sum_in_f64``, the float64 sums of
    float32 operands; fault 3.10), let through while it runs. Float32
    library solves (the fits past k = 512, the polish past K = 48) stay
    (ROADMAP 3.18)."""
    from morbit_tpu_torch.ops import batched_linalg, dense_kernels, prepare_fused, qp_lane

    def guard(name, fn):
        def wrapped(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise RuntimeError(f"the plain twin {name} ran on a CUDA tensor")
            return fn(*args, **kw)
        return wrapped

    widening = [0]

    def refuse(name, fn):
        def wrapped(*args, **kw):
            if not widening[0] and any(t.is_cuda and t.dtype == torch.float64
                                       for t in _tensors(args)):
                raise RuntimeError(f"the library call {name} ran on a float64 CUDA tensor")
            return fn(*args, **kw)
        return wrapped

    def widened(fn):
        def wrapped(*args, **kw):
            widening[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                widening[0] -= 1
        return wrapped

    twins = [(qp_lane, "admm_stages_plain"), (qp_lane, "admm_stages_exit_plain"),
             (prepare_fused, "rbf_selection_core"),
             (prepare_fused, "run_round4"), (dense_kernels, "rbf_gram_matrix_plain"),
             (dense_kernels, "admm_iterations_plain")]
    with contextlib.ExitStack() as stack:
        for mod, attr in twins:
            stack.enter_context(mock.patch.object(mod, attr, guard(attr, getattr(mod, attr))))
        for mod, attr in F64_LIBRARY:
            stack.enter_context(mock.patch.object(mod, attr, refuse(attr, getattr(mod, attr))))
        stack.enter_context(mock.patch.object(batched_linalg, "_sum_in_f64",
                                              widened(batched_linalg._sum_in_f64)))
        yield


def wide_mop(n=N_WIDE):
    from morbit_tpu_torch.models.configs import RbfConfig
    from morbit_tpu_torch.problems.synthetic import make_zdt

    return make_zdt("zdt1", n, model_cfg=RbfConfig(kernel="cubic"))


def front_error(fx):
    """|f2 - (1 - sqrt(f1))| per lane: the distance in f2 to the ZDT1
    front (``tests/test_zdt_quality.py::_front_err``)."""
    f1 = torch.clamp(fx[:, 0], min=0.0)
    return (fx[:, 1] - (1.0 - torch.sqrt(f1))).abs()


def _quantiles(t):
    t = t.double().cpu()
    return {"min": float(t.min()), "median": float(t.median()), "max": float(t.max())}


def phase_wide_main_path(B, n=N_WIDE, budget=WIDE_BUDGET, sustained=WIDE_SUSTAINED,
                         capture=WIDE_CAPTURE_CALLS, name="wide_main_path"):
    """A wide-n path at float32: ZDT1 at n variables, both objectives in one
    cubic RBF group, ``budget``, B Halton starts, the plain runner. The
    counts are set to 0 just before each batch and read just after it; each
    kernel K1-K4 must launch at least once a trip. The first batch records
    the K1-K4 inputs of the calls in ``capture``, and no plain twin may run
    on the card in it; ``sustained`` batches follow on other starts."""
    from morbit_tpu_torch import STOP_CODE, AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.problems.synthetic import halton_starts

    mop = wide_mop(n)
    ac = AlgorithmConfig(**budget)
    starts = [torch.as_tensor(halton_starts(B, mop.lb, mop.ub, 1 + k * B),
                              dtype=torch.float32, device="cuda")
              for k in range(1 + sustained)]
    captured = {"qp_admm": [], "selection": [], "round4": [], "gram": []}

    def batch(x0, record):
        # each batch starts from a released cache: blocks cached by the paths
        # before, split among tensors that still live, leave no room for the
        # n=50 path's 7.8 GB fit matrices (on a failed allocation PyTorch
        # frees only wholly unused blocks)
        torch.cuda.empty_cache()
        _zero_all_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if record:
                stack.enter_context(kernels_only())
                stack.enter_context(recording(captured, capture))
            res = multistart_optimize(mop, x0, ac, dtype=torch.float32)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _all_launch_counts()
        for kernel, count in launches.items():
            check(count >= res.trips,
                  f"{kernel} launched {count} times in {res.trips} trips of {name}")
        return res, seconds, launches

    torch.cuda.reset_peak_memory_stats()
    res, first_s, launches = batch(starts[0], True)
    peak = torch.cuda.max_memory_allocated()
    check(bool(((res.stop_code >= STOP_CODE.MAX_ITER)
                & (res.stop_code <= STOP_CODE.INFEASIBLE)).all()), "invalid stop code")
    check(bool(torch.isfinite(res.x).all() and torch.isfinite(res.fx).all()),
          "non-finite x or fx")
    check(tuple(res.x.shape) == (B, n), f"x has shape {tuple(res.x.shape)}")
    first = dict(
        front_error=_quantiles(front_error(res.fx)),
        mean_iterations=float(res.n_iterations.double().mean()),
        mean_evals=float(res.n_evals.double().mean()),
        stop_codes={STOP_CODE(c).name: int((res.stop_code == c).sum()) for c in range(2, 7)},
        db_rows=int(res.state.groups[0].db.data.shape[1]))
    trips = res.trips
    del res   # the sustained batches run without the first batch's state
    runs = []
    for x0 in starts[1:]:
        r_, s_, l_ = batch(x0, False)
        runs.append((r_.trips, s_, l_))
        del r_
    torch.cuda.empty_cache()   # and the phases after start from one too
    dt = sum(s for _, s, _ in runs)
    phase(name, B=B, dtype="float32", n=n, problem="zdt1",
          model="RbfConfig(kernel='cubic')", budget=budget,
          launches_per_batch=[launches] + [l for _, _, l in runs],
          trips_per_batch=[trips] + [t for t, _, _ in runs],
          first_batch_s=first_s, sustained_s=[s for _, s, _ in runs],
          runs_per_s=len(runs) * B / dt if runs else B / first_s, **first,
          max_memory_allocated_bytes=peak,
          recorded_calls={k: len(v) for k, v in captured.items()})
    return launches, captured


def twin_lanes(name, X):
    """Lanes of a K2 or K3 set (sites ``X``, (B, rows, n)) that the twin
    runs and the kernel is held on: ``WIDE50_TWIN_LANES`` on the n=50
    path's call, at most ``WIDE_TWIN_LANES`` on other sets at n >=
    ``N_WIDE``, else all."""
    if name.startswith("wide50"):
        return WIDE50_TWIN_LANES
    return min(X.shape[0], WIDE_TWIN_LANES) if X.shape[-1] >= N_WIDE else X.shape[0]


def _selection_tensors(case, dtype):
    X, count, x_s, x_index, delta, lb, ub, max_new, efl = case
    f = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    i = lambda a: torch.as_tensor(a, dtype=torch.int32, device="cuda")
    return (f(X), i(count), f(x_s), i(x_index), f(delta), f(lb), f(ub), i(max_new),
            torch.as_tensor(efl, device="cuda"))


def phase_kernel_selection(captured, wide_captured, staged_captured, option_captured,
                           wide50_captured=()):
    """K2 against its twin on the card, the inputs recorded on the staged
    main path (a stage capacity, a compacted width) and on the option paths
    (the composite path's cubic group, the rescaled sites of the 'model'
    scaler, the fixed capacity of ``use_db=False``) included; returns the
    rows of the last recorded call of the RBF main path (cap 1507) and of
    the wide path (n=20, cap 5332), both float32, the option paths'
    float32 rows by path and the n=50 path's float32 row (the wide
    instance; the kernel runs all lanes, the twin the first
    ``WIDE50_TWIN_LANES``, on which the kernel is held)."""
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
    sets += [(f"wide50_path_call{t}", recorded(a), kw)
             for t, (a, kw) in zip(WIDE50_CAPTURE_CALLS, wide50_captured)]
    sets += [(f"staged_B{a[0].shape[0]}_cap{a[0].shape[1]}", recorded(a), kw)
             for a, kw in staged_captured]
    sets += [(f"{kind}_path_B{a[0].shape[0]}_cap{a[0].shape[1]}", recorded(a), kw)
             for kind, cap in option_captured.items() for a, kw in cap["selection"]]
    rows = {}
    for dtype in (torch.float64, torch.float32):
        for name, make, kw in sets:
            if name.startswith("wide50") and dtype == torch.float64:
                continue   # the path's dtype only (see WIDE50_TWIN_LANES)
            args = make(dtype)
            before = prepare_fused.selection_launches
            k_all = prepare_fused.selection_cuda(*args, **kw)
            L = twin_lanes(name, args[0])
            k = tuple(o[:L] for o in k_all)
            t_args = tuple(a[:L] for a in args)
            t, plain_ms = timed(lambda: rbf_selection_core(*t_args, **kw))
            check(prepare_fused.selection_launches == before + 1, "K2 launch not counted")
            # every output equal to the twin's, floats to the bit (NaN where
            # the twin has NaN)
            err, lanes = 0.0, torch.zeros(L, dtype=torch.bool, device="cuda")
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
            ops, nbytes = selection_work(args, k_all)
            bound_ms, bound_by = bound(ops, nbytes, dtype)
            row = dict(set=name, dtype=str(dtype), B=int(args[0].shape[0]),
                       cap=int(args[0].shape[1]), n=int(args[0].shape[2]), twin_lanes=L,
                       max_valid_rows=int(args[1].max()), max_abs_err=err, tol=0.0,
                       lanes_differing=len(bad), ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, ops=ops, bytes=nbytes)
            phase("kernel_selection", **row)
            rows[(name.split("_trip")[0].split("_call")[0], dtype)] = row
    options = {kind: row for (name, dt), row in rows.items() for kind in option_captured
               if name.startswith(kind + "_path") and dt == torch.float32}
    return (rows[("main_path", torch.float32)], rows[("wide_path", torch.float32)], options,
            rows.get(("wide50_path", torch.float32)))


def phase_kernel_round4(captured, wide_captured, staged_captured, option_captured,
                        wide50_captured=()):
    """K3 against its twin on the card, the inputs recorded on the staged
    main path and on the option paths included; returns the rows of the
    last recorded call of the RBF main path and of the wide path, float32,
    the option paths' float32 rows by path and the n=50 path's float32 row.
    On the n=50 path's call (the slot instance) the kernel runs all lanes
    and the twin the first ``WIDE50_TWIN_LANES``, against which the
    kernel's lanes are held; the counts of the bound are the kernel's."""
    from morbit_tpu_torch.models.rbf_round4 import run_round4
    from morbit_tpu_torch.ops import prepare_fused
    from morbit_tpu_torch.ops.rbf import poly_dim

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
    sets += [(f"wide50_path_call{t}", recorded(a, kw), False)
             for t, (a, kw) in zip(WIDE50_CAPTURE_CALLS, wide50_captured)]
    sets += [(f"staged_B{a[0].shape[0]}_C{a[0].shape[1]}", recorded(a, kw), False)
             for a, kw in staged_captured]
    sets += [(f"{kind}_path_B{a[0].shape[0]}_C{a[0].shape[1]}", recorded(a, kw), False)
             for kind, cap in option_captured.items() for a, kw in cap["round4"]]
    rows = {}
    for dtype in (torch.float64, torch.float32):
        for name, make, must_reject in sets:
            if name.startswith("wide50") and dtype == torch.float64:
                continue   # the path's dtype only (see WIDE50_TWIN_LANES)
            args, kw = make(dtype)
            before = prepare_fused.round4_launches
            acc_k, N_k = prepare_fused.round4_cuda(*args, **kw)
            L = twin_lanes(name, args[0])
            t_args = tuple(a[:L] for a in args)
            t_kw = {k: v[:L] if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
            (acc_t, N_t), plain_ms = timed(lambda: run_round4(*t_args, **t_kw))
            check(prepare_fused.round4_launches == before + 1, "K3 launch not counted")
            lanes = (acc_k[:L] != acc_t).any(-1) | (N_k[:L] != N_t)
            if L < args[0].shape[0]:   # held on the twin's lanes, counted on all
                acc_t, N_t = acc_k, N_k
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
                       C=int(args[0].shape[1]), n=int(args[0].shape[2]), twin_lanes=L,
                       instance=prepare_fused.round4_plan(
                           kw["max_points"], int(args[0].shape[2]),
                           poly_dim(int(args[0].shape[2]), kw["poly_deg"]),
                           args[0].element_size()).instance,
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
    options = {kind: row for (name, dt), row in rows.items() for kind in option_captured
               if name.startswith(kind + "_path") and dt == torch.float32}
    return (rows[("main_path", torch.float32)], rows[("wide_path", torch.float32)], options,
            rows.get(("wide50_path", torch.float32)))


def _compare_states(card, cpu, allowed=None):
    """Leaf by leaf and lane by lane: integer leaves equal (the stamped
    it_stat and x_indices included), floats within 1e-9 + 1e-6 |x| with the
    same non-finite entries. Two floats are reported instead of held to
    that: the stamped rho, a ratio of differences of nearly equal values
    near a critical point, and the fitted RBF coefficients, conditioned like
    the Gram matrix and seen only through the model values. The lanes
    ``allowed`` (B,) marks may part; any other lane that parts fails.
    Returns the largest relative differences of the two reported floats
    over the lanes that did not part, the (B,) mask of the lanes that
    parted, and for each of those lanes where it parts: its first parting
    leaf (in the state's order) with the largest difference there, and
    every integer leaf that differs."""
    from morbit_tpu_torch.utils.carry import state_to_numpy

    a, b = state_to_numpy(card), state_to_numpy(cpu)
    B = cpu.x.shape[0]
    allowed = np.zeros(B, bool) if allowed is None else np.asarray(allowed)
    rho_col = cpu.traj.n + cpu.traj.m + 1
    reported = {"rho": [], "fit": []}
    apart = np.zeros(B, bool)
    parts = {}
    for name, va in a.items():
        vb = b[name]
        if ".model.fit." in name:
            reported["fit"].append((va, vb))
            continue
        if name == "traj.data":
            reported["rho"].append((va[..., rho_col], vb[..., rho_col]))
            va, vb = np.delete(va, rho_col, -1), np.delete(vb, rho_col, -1)
        if va.dtype.kind in "biu":
            bad = va != vb
        else:
            fin = np.isfinite(vb)
            va_f, vb_f = np.where(fin, va, 0.0), np.where(fin, vb, 0.0)
            bad = ((np.isfinite(va) != fin) | (~fin & (va != vb))
                   | ~(np.abs(va_f - vb_f) <= 1e-9 + 1e-6 * np.abs(vb_f)))
        bad = bad.reshape(B, -1)
        for i in np.nonzero(bad.any(-1))[0].tolist():
            part = parts.setdefault(i, {"leaf": name, "max_abs_diff": float(np.nanmax(
                np.abs(va[i].astype(float) - vb[i].astype(float)), initial=0.0)),
                "integer_leaves": []})
            if va.dtype.kind in "biu":
                part["integer_leaves"].append(name)
        bad = bad.any(-1)
        lanes = np.nonzero(bad & ~allowed)[0]
        if lanes.size:
            err = np.abs(va[lanes].astype(float) - vb[lanes].astype(float))
            check(False, f"{name} differs on lanes {lanes.tolist()[:16]}: |diff| "
                  f"{float(np.nanmax(err, initial=0.0))}")
        apart |= bad

    def rel(x, y):
        with np.errstate(invalid="ignore"):
            return float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1.0),
                                initial=0.0, where=np.isfinite(y)))
    return ({k: max((rel(x[~apart], y[~apart]) for x, y in pairs), default=0.0)
             for k, pairs in reported.items()}, apart, parts)


def duplicate_site_lanes(state):
    """(B,) bool: lanes whose databases hold one site in two valid rows.
    Round 4 tests such a row with a tau^2 that is rounding noise against
    1e-28 (ROADMAP 3.6), so card and CPU may decide it differently there."""
    from morbit_tpu_torch.core.database import valid_mask

    dup = torch.zeros(state.x.shape[0], dtype=torch.bool)
    for g in state.groups:
        X = g.db.X.cpu()
        ok = valid_mask(g.db).cpu()
        same = (X[:, :, None, :] == X[:, None, :, :]).all(-1) & ok[:, :, None] & ok[:, None, :]
        same &= ~torch.eye(X.shape[1], dtype=torch.bool)
        dup |= same.flatten(1).any(-1)
    return dup.numpy()


def lockstep(make_mop, starts, ac, may_part=None, eligible=None, describe=None, theta=()):
    """Trip by trip at float64: the card's trip from the CPU's state equals
    the CPU's trip (``_compare_states``); ``theta``, a parametric problem's
    per-lane leaves, goes into both initial states. With ``may_part``, a collection of
    (trip, lane) pairs, such a lane may part at such a trip if
    ``eligible(state)`` (default ``duplicate_site_lanes``: its database then
    holds one site twice) marks it; any other parting lane fails. Returns
    the trips, the seconds, the largest relative differences of the
    reported floats, the (trip, lane) pairs that parted (trip -1: the
    initialization; with ``describe``, a dict of them to
    ``describe(card, cpu, lane)``) and, with ``may_part``, the eligible
    lanes at each trip that has some."""
    eligible = eligible or duplicate_site_lanes
    from morbit_tpu_torch import STOP_CODE
    from morbit_tpu_torch.parallel.multistart import build_solver
    from morbit_tpu_torch.utils.tree import tree_map, tree_where

    on = {d: build_solver(make_mop(), ac, torch.float64, d) for d in ("cuda", "cpu")}
    t0 = time.perf_counter()
    lanes = lambda d: tuple(t.to(d) for t in theta)
    state = on["cpu"].initialize(starts, theta=lanes("cpu"))
    card = on["cuda"].initialize(starts, theta=lanes("cuda"))
    allowed = None
    if may_part is not None:   # the initialization is trip -1
        allowed = eligible(state) & np.isin(np.arange(state.x.shape[0]),
                                            [lane for trip, lane in may_part if trip == -1])
    diffs, apart, _ = _compare_states(card, state, allowed)
    trips, parted, seen, cards, states = 0, [(-1, int(i)) for i in np.nonzero(apart)[0]], {}, {}, {}
    if describe is not None and apart.any():
        cards[-1], states[-1] = card, state
    while bool((state.stop_code == STOP_CODE.CONTINUE).any()):
        card_in = tree_map(lambda t: t.to("cuda"), state)
        run_card = card_in.stop_code == STOP_CODE.CONTINUE
        card = tree_where(run_card, on["cuda"].iterate(card_in), card_in)
        running = state.stop_code == STOP_CODE.CONTINUE
        allowed = None
        if may_part is not None:
            dup = eligible(state)
            if dup.any():
                seen[trips] = np.nonzero(dup)[0].tolist()
            allowed = dup & np.isin(np.arange(dup.size),
                                    [lane for trip, lane in may_part if trip == trips])
        state = tree_where(running, on["cpu"].iterate(state), state)
        d, apart, _ = _compare_states(card, state, allowed)
        if describe is not None and apart.any():
            cards[trips], states[trips] = card, state
        diffs = {k: max(v, d[k]) for k, v in diffs.items()}
        parted += [(trips, int(i)) for i in np.nonzero(apart)[0]]
        trips += 1
    if describe is not None:
        parted = {(t, i): describe(cards[t], states[t], i) for t, i in parted}
    return trips, time.perf_counter() - t0, diffs, parted, seen


def phase_rbf_card_vs_cpu():
    """The RBF main path at float64 on the card and on the CPU."""
    from morbit_tpu_torch import AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.problems.synthetic import halton_starts
    from morbit_tpu_torch.utils.logging import trajectory_arrays

    B = 64
    starts = halton_starts(B, LB, UB)
    ac = AlgorithmConfig(max_iter=100, qp_iters=QP_ITERS)
    trips, lockstep_s, diffs, _, _ = lockstep(rbf_mop, starts, ac)

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


#: interleaved rounds of the plain and the tuned runner on the constrained
#: path, after the probe's batch
CONSTRAINED_ROUNDS = 1
#: the call of each K1 LP shape whose inputs the constrained path records
CONSTRAINED_CAPTURE_CALL = 8


def constrained_mop():
    from morbit_tpu_torch.models.configs import RbfConfig
    from morbit_tpu_torch.problems.synthetic import make_constrained_two_parabolas

    return make_constrained_two_parabolas(RbfConfig(kernel="multiquadric"), LB, UB)


def constrained_pareto_fraction(x, tol=1e-2):
    """Share of lanes strictly within ``tol`` of the constrained Pareto set,
    the segment {(t, t) : t in [-1, 0.5]} (a gauge only)."""
    x = x.detach().double().cpu().numpy()
    t = np.clip((x[:, 0] + x[:, 1]) / 2.0, -1.0, 0.5)
    return float(np.mean(np.linalg.norm(x - t[:, None], axis=1) < tol))


@contextlib.contextmanager
def k1_shapes(tally):
    """Count the K1 calls by (nv, m) into ``tally``, its fixed-trip and exit
    instances alike (each CUDA call launches the kernel once; the phase
    checks the tally against the kernel's own count, ``qp_lane.launches``)."""
    from morbit_tpu_torch.ops import qp_lane

    def counted(inner):
        def wrapped(P, q, A, *args, **kw):
            key = f"nv{A.shape[-1]}_m{A.shape[-2]}"
            tally[key] = tally.get(key, 0) + 1
            return inner(P, q, A, *args, **kw)
        return wrapped
    with mock.patch.object(qp_lane, "admm_stages", counted(qp_lane.admm_stages)), \
            mock.patch.object(qp_lane, "admm_stages_exit", counted(qp_lane.admm_stages_exit)):
        yield


@contextlib.contextmanager
def k1_stage_counts(counts):
    """Add the stages each lane of each K1 exit launch ran to the histogram
    ``counts["hist"]`` (a tensor indexed by the stage count, summed on the
    device: no sync a launch)."""
    from morbit_tpu_torch.ops import qp_lane

    inner = qp_lane.admm_stages_exit

    def wrapped(*args, **kw):
        out = inner(*args, **kw)
        hist = torch.bincount(out[3].long(), minlength=kw["n_stages"] + 1)
        counts["hist"] = hist if "hist" not in counts else counts["hist"] + hist
        return out
    with mock.patch.object(qp_lane, "admm_stages_exit", wrapped):
        yield


def constrained_shapes():
    """A ``recording`` predicate: K1's inputs at the CONSTRAINED_CAPTURE_CALL-th
    call of each of its two constrained LP shapes."""
    calls = {}

    def keep(name, call, args):
        shape = tuple(args[2].shape[-2:])
        calls[shape] = calls.get(shape, 0) + 1
        return calls[shape] == CONSTRAINED_CAPTURE_CALL
    return keep


def _constrained_summary(res):
    from morbit_tpu_torch import STOP_CODE
    from morbit_tpu_torch.core.filter import compute_constraint_val

    st = res.state
    theta = compute_constraint_val(st.l_e, st.l_i, st.c_e, st.c_i)
    codes = {STOP_CODE(c).name: int((res.stop_code == c).sum()) for c in range(2, 7)}
    return dict(trips=res.trips, stop_codes=codes,
                infeasible=codes["INFEASIBLE"],
                feasible_share=float((theta <= 1e-6).double().mean()),
                constrained_pareto_fraction_1e2=constrained_pareto_fraction(res.x),
                mean_iterations=float(res.n_iterations.double().mean()),
                mean_evals=float(res.n_evals.double().mean()))


def phase_constrained_main_path():
    """The constrained configuration at float32, B=1024, both budgets: the
    probe protocol (``bench.tuned_runner``), then the plain runner and the
    tuned ``StagedMultistart`` in turns on the probe's starts and on
    CONSTRAINED_ROUNDS more batches. The counts are set to 0 just before
    each budget and read just after it, under ``kernels_only``; the runs
    record K1's inputs at both LP shapes. Returns the launches of each
    budget (K1's by shape too) and the recorded inputs."""
    from morbit_tpu_torch.bench import tuned_runner
    from morbit_tpu_torch.core.config import AlgorithmConfig
    from morbit_tpu_torch.parallel.multistart import build_solver, capacity_overflowed
    from morbit_tpu_torch.problems.synthetic import halton_starts

    cuda = torch.device("cuda")
    captured = {"qp_admm": []}
    keep = constrained_shapes()
    launches = []
    for budget in STAGED_BUDGETS:
        ac = AlgorithmConfig(**budget)
        starts = [torch.as_tensor(halton_starts(B_MAIN, LB, UB, 1 + k * B_MAIN),
                                  dtype=torch.float32, device=cuda)
                  for k in range(1 + CONSTRAINED_ROUNDS)]
        torch.cuda.synchronize()
        _zero_launch_counts()
        shapes = {}
        results = []
        batch_s = {"plain": [], "tuned": []}
        t0 = time.perf_counter()
        with kernels_only(), recording(captured, keep), k1_shapes(shapes):
            runner, probe = tuned_runner(constrained_mop(), ac, torch.float32, cuda,
                                         starts[0])
            plain = build_solver(constrained_mop(), ac, torch.float32, cuda)
            runner.solver.restoration_iterations = 0
            for x0 in starts:
                for name, run in (("plain", plain.solve), ("tuned", runner)):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    results.append((name, run(x0)))
                    torch.cuda.synchronize()
                    batch_s[name].append(time.perf_counter() - t1)
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
        trips = probe.trips + sum(r.trips for _, r in results)
        for name, count in counts.items():
            check(count >= trips, f"{name} launched {count} times in {trips} trips")
        check(set(shapes) >= {"nv3_m8", "nv4_m11"}, f"K1 shapes {shapes}")
        check(sum(shapes.values()) == counts["qp_admm"],
              f"K1 calls by shape {shapes} do not add up to its {counts['qp_admm']} launches")
        check(not any(capacity_overflowed(r) for n, r in results if n == "tuned"),
              "a tuned constrained batch overflowed its database")
        for _, r in results:
            _check_result(r, B_MAIN)
        p, t = results[0][1], results[1][1]
        flips = int(((p.stop_code != t.stop_code) | (p.n_iterations != t.n_iterations)).sum())
        rest = {name: solver.restoration_iterations
                / sum(r.trips for n, r in results if n == name)
                for name, solver in (("plain", plain), ("tuned", runner.solver))}
        phase("constrained_main_path", B=B_MAIN, dtype="float32", **budget,
              model="RbfConfig(kernel='multiquadric') + x1+x2<=1 + exact ||x||^2<=2.25",
              launches=counts, k1_launches_by_shape=shapes, trips_all_batches=trips,
              seconds=seconds, probe_trips=probe.trips,
              db_capacity=runner.solver.db_capacity,
              schedule=[t for t, _ in runner.schedule], widths=list(runner.widths),
              restoration_iterations_per_trip=rest,
              runs_per_s={k: len(v) * B_MAIN / sum(v) for k, v in batch_s.items()},
              batch_s=batch_s, lanes_differing_plain_vs_tuned=flips,
              plain=_constrained_summary(p), tuned=_constrained_summary(t))
        launches.append(dict(counts, qp_admm_by_shape=shapes))
    check(len(captured["qp_admm"]) == 2, f"recorded {len(captured['qp_admm'])} K1 "
          "calls at the constrained LP shapes, expected 2")
    return launches, captured["qp_admm"]


#: the (trip, lane) pairs of ``constrained_card_vs_cpu`` recorded parting on
#: a duplicate site (ROADMAP 3.6)
CONSTRAINED_MAY_PART = {(3, 17)}


def phase_constrained_card_vs_cpu():
    """The constrained configuration at float64 on the card and on the
    CPU, trip by trip from the same state (``lockstep``). A trial point can
    land exactly on an earlier model-improvement site (both on the trust
    region's boundary along one direction), so a lane's database can hold
    one site twice; round 4 then tests the copy with a tau^2 that is
    rounding noise (ROADMAP 3.6: the JAX package accepts it on some lanes
    and its fit turns NaN). Only the recorded pairs CONSTRAINED_MAY_PART
    may part, and only while the lane holds such a site; the lanes holding
    one are listed trip by trip, and every other lane and trip is held."""
    from morbit_tpu_torch import AlgorithmConfig
    from morbit_tpu_torch.problems.synthetic import halton_starts

    B = 64
    ac = AlgorithmConfig(max_iter=25, qp_iters=QP_ITERS)
    trips, seconds, diffs, parted, eligible = lockstep(
        constrained_mop, halton_starts(B, LB, UB), ac, may_part=CONSTRAINED_MAY_PART)
    phase("constrained_card_vs_cpu", B=B, dtype="float64", max_iter=25,
          lockstep_trips=trips, lockstep_s=seconds,
          lockstep_rho_max_rel_diff=diffs["rho"], lockstep_fit_max_rel_diff=diffs["fit"],
          duplicate_site_lanes_by_trip=eligible, parted=parted,
          may_part=sorted(CONSTRAINED_MAY_PART))


#: the Taylor, Lagrange and Pascoletti-Serafini paths on
#: the main path's problem (two parabolas on [-4, 4]^2, both objectives in
#: one group): a degree-2 finite-difference Taylor group and a degree-2
#: Lagrange group with steepest descent, and the main path's multiquadric
#: RBF group with Pascoletti-Serafini descent at the reference budgets
#: (ideal-point sweeps, a 1,500-point grid, no polish)
FAMILY_KINDS = ("taylor", "lagrange", "ps")
#: the composite, scaling and database paths: ``examples/composites.py``'s
#: problem (g(x) = (||x-a||^2, ||x+a||^2), a = (1, 1), in one cubic RBF
#: group; the composite objectives g0 and g1 + 0.1 x0 and the composite
#: constraint g0 - 9 <= 0) on [-4, 4]^2, and the main path with the
#: per-iteration ``var_scaler_update='model'`` or with ``use_db=False``; the
#: main path with both objectives as NumPy host functions (``host=True,
#: can_batch=True``, one multiquadric group), with the QP's early exit
#: (``qp_exit_eps=EXIT_EPS``), and with ``RbfConfig(use_max_points=True)``
#: and ``use_db=False`` (56 rows, so every round 4 also scans 60 random
#: candidates: K3 at C = 116); the same protocol and lockstep as the
#: families
OPTION_KINDS = ("composite", "scaler_model", "no_db", "host", "exit_eps", "max_points")
#: the QP's exit tolerance on the exit_eps path
EXIT_EPS = 1e-5
#: interleaved rounds of the plain and the tuned runner after the probe
#: (none: the pair on the probe's starts gives the rates, which keeps the
#: script within its time limit beside the n=50 path)
FAMILY_ROUNDS = 0
#: max_iter of the float64 card-vs-CPU lockstep of each family (25 before
#: the n=50 path joined the script; cut for its time limit)
FAMILY_LOCKSTEP_ITERS = 10
#: the (trip, lane) pairs of each family's lockstep recorded parting, with
#: the cause ``family_part_cause`` names
FAMILY_MAY_PART = {"taylor": {}, "lagrange": {}, "ps": {}, "composite": {},
                   "scaler_model": {}, "no_db": {}, "host": {}, "exit_eps": {},
                   "max_points": {}}
#: the call of each K1 shape, and of K2 and K3, whose inputs the option
#: paths record
OPTION_CAPTURE_CALL = 8


def host_parabolas(can_batch=True):
    """The main path's problem with both objectives as NumPy functions on
    the host, in one multiquadric group: the same IEEE operations as the
    torch functions of ``make_two_parabolas`` (a square, then the sum of two
    terms), so the values agree to the bit."""
    from morbit_tpu_torch import MOP
    from morbit_tpu_torch.models.configs import RbfConfig

    mop = MOP(LB, UB)
    for c in (1.0, -1.0):
        mop.add_objective(lambda X, c=c: ((X - c) ** 2).sum(-1),
                          model_cfg=RbfConfig(kernel="multiquadric"), host=True,
                          can_batch=can_batch)
    return mop


def family_mop(kind):
    from morbit_tpu_torch.models.configs import LagrangeConfig, RbfConfig, TaylorConfig
    from morbit_tpu_torch.problems.synthetic import make_composite, make_two_parabolas

    if kind == "composite":
        return make_composite(RbfConfig(kernel="cubic"), LB, UB)
    if kind == "host":
        return host_parabolas()
    cfg = {"taylor": TaylorConfig(degree=2, mode="fd"),
           "lagrange": LagrangeConfig(degree=2),
           "max_points": RbfConfig(kernel="multiquadric", use_max_points=True)}.get(
               kind, RbfConfig(kernel="multiquadric"))
    return make_two_parabolas(cfg, LB, UB)


def family_config(kind, **budget):
    from morbit_tpu_torch import AlgorithmConfig
    from morbit_tpu_torch.core.descent import PascolettiSerafiniConfig

    if kind == "ps":
        budget["descent_method"] = PascolettiSerafiniConfig()
    if kind == "scaler_model":
        budget["var_scaler_update"] = "model"
    if kind in ("no_db", "max_points"):
        budget["use_db"] = False
    if kind == "exit_eps":
        budget["qp_exit_eps"] = EXIT_EPS
    return AlgorithmConfig(**budget)


def option_shapes():
    """A ``recording`` predicate: K1's inputs at the OPTION_CAPTURE_CALL-th
    call of each LP shape but the main path's (3, 6), and K2's and K3's at
    their OPTION_CAPTURE_CALL-th call."""
    calls = {}

    def keep(name, call, args):
        if name != "qp_admm":   # K2, K3 and K1's exit instance
            return call == OPTION_CAPTURE_CALL
        shape = tuple(args[2].shape[-2:])
        calls[shape] = calls.get(shape, 0) + 1
        return shape != (6, 3) and calls[shape] == OPTION_CAPTURE_CALL
    return keep


def _composite_summary(res):
    """The composite path's feasible share (theta <= 1e-6), and that one
    group's counter counts every true call of g: its evaluated database
    rows, lane by lane, equal its counter and the result's evaluations."""
    from morbit_tpu_torch.core.database import valid_mask
    from morbit_tpu_torch.core.filter import compute_constraint_val

    st = res.state
    check(len(st.groups) == 1, f"{len(st.groups)} groups on the composite path, expected 1")
    g = st.groups[0]
    rows = (valid_mask(g.db) & g.db.evaluated).sum(-1).to(torch.int32)
    check(bool((rows == g.n_evals).all() and (res.n_evals == g.n_evals).all()),
          "the composite group's counter does not count the true calls of g")
    theta = compute_constraint_val(st.l_e, st.l_i, st.c_e, st.c_i)
    return dict(groups=len(st.groups), true_calls_counted=True,
                feasible_share=float((theta <= 1e-6).double().mean()),
                constraint_max=float(st.c_i.max()))


def family_part_cause(card, cpu, lane):
    """Why one lane of a lockstep trip parted: the first leaf (in name
    order) that differs, and for a Lagrange group whether a candidate pick
    differs (the poised set's database rows: a pick between |l_i| values
    that tie up to rounding) or a point the ascent generated."""
    from morbit_tpu_torch.utils.carry import state_to_numpy

    a, b = state_to_numpy(card), state_to_numpy(cpu)
    for name in sorted(a):
        va, vb = a[name][lane], b[name][lane]
        if va.dtype.kind in "biu":
            same = np.array_equal(va, vb)
        else:
            same = np.allclose(va, vb, rtol=1e-6, atol=1e-9, equal_nan=True)
        if not same:
            break
    else:
        return "none"
    if "groups.0.model.idx" in a and not np.array_equal(a["groups.0.model.idx"][lane],
                                                         b["groups.0.model.idx"][lane]):
        return f"{name}: a candidate pick (poised-set rows differ)"
    if "groups.0.model.idx" in a:
        return f"{name}: an ascent-generated point entering the model"
    return name


def phase_family_main_path(kind):
    """The Taylor, Lagrange, PS, composite, 'model'-scaler or no-database
    path at float32, B=1024, the reference budget: the probe
    protocol (``bench.tuned_runner``), then the plain runner and the tuned
    ``StagedMultistart`` in turns on the probe's starts and on FAMILY_ROUNDS
    more batches, under ``kernels_only``. The counts are set to 0 just
    before and read just after. K1 must launch at least once a trip on the
    steepest-descent paths, K2 and K3 on the RBF paths; the tuned and plain
    runners must agree on every lane's stop code and iteration count, and
    no database may overflow. The option paths record K1's inputs at each
    LP shape but (3, 6) and K2's and K3's (``option_shapes``). Returns the
    launches and the recorded inputs."""
    from morbit_tpu_torch.bench import tuned_runner
    from morbit_tpu_torch.ops import boxopt
    from morbit_tpu_torch.parallel.multistart import (build_solver, capacity_overflowed,
                                                      fleet_eligible)
    from morbit_tpu_torch.problems.synthetic import halton_starts

    cuda = torch.device("cuda")
    budget = dict(max_iter=100, qp_iters=QP_ITERS)
    ac = family_config(kind, **budget)
    starts = [torch.as_tensor(halton_starts(B_MAIN, LB, UB, 1 + k * B_MAIN),
                              dtype=torch.float32, device=cuda)
              for k in range(1 + FAMILY_ROUNDS)]
    results, batch_s = [], {"plain": [], "tuned": []}
    captured = {"qp_admm": [], "qp_admm_exit": [], "selection": [], "round4": []}
    keep = option_shapes() if kind in OPTION_KINDS else (lambda *a: False)
    shapes, stage_counts = {}, {}
    # one problem object for both runners: a host function's tallies then
    # count every batch of the phase
    mop = family_mop(kind)
    torch.cuda.synchronize()
    _zero_launch_counts()
    boxopt.ascent_steps = 0
    t0 = time.perf_counter()
    with kernels_only(), recording(captured, keep), k1_shapes(shapes), \
            k1_stage_counts(stage_counts):
        runner, probe = tuned_runner(mop, ac, torch.float32, cuda, starts[0])
        plain = build_solver(mop, ac, torch.float32, cuda)
        for x0 in starts:
            for name, run in (("plain", plain.solve), ("tuned", runner)):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                results.append((name, run(x0)))
                torch.cuda.synchronize()
                batch_s[name].append(time.perf_counter() - t1)
    seconds = time.perf_counter() - t0
    counts = _launch_counts()
    trips = probe.trips + sum(r.trips for _, r in results)
    need = (() if kind == "ps" else ("qp_admm",)) + (
        () if kind in ("taylor", "lagrange") else ("rbf_selection", "rbf_round4"))
    for name in need:
        check(counts[name] >= trips, f"{name} launched {counts[name]} times in {trips} trips")
    check(sum(shapes.values()) == counts["qp_admm"],
          f"K1 calls by shape {shapes} do not add up to its {counts['qp_admm']} launches")
    overflow = capacity_overflowed(probe) or any(capacity_overflowed(r) for _, r in results)
    check(not overflow, f"a {kind} batch overflowed its database")
    for _, r in results:
        _check_result(r, B_MAIN)
    flips = 0
    for k in range(0, len(results), 2):
        p, t = results[k][1], results[k + 1][1]
        flips += int(((p.stop_code != t.stop_code) | (p.n_iterations != t.n_iterations)).sum())
    check(flips == 0, f"{flips} lanes differ between the plain and the tuned {kind} runner")
    p, t = results[0][1], results[1][1]
    ascent_steps = boxopt.ascent_steps
    skips = {}
    if kind == "lagrange":
        # the skipped ascents change no result: the plain runner on the
        # probe's starts with every ascent run, against the same with skips
        from morbit_tpu_torch.models import lagrange

        boxopt.ascent_steps = 0
        with kernels_only(), mock.patch.object(lagrange, "SKIP_IDLE_ASCENTS", False):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            full = plain.solve(starts[0])
            torch.cuda.synchronize()
        same = all(torch.equal(getattr(full, f), getattr(p, f))
                   for f in ("x", "fx", "stop_code", "n_iterations", "n_evals"))
        check(same, "the Lagrange path without the skips differs from the path with them")
        skips = dict(no_skips_batch_s=time.perf_counter() - t1,
                     no_skips_ascent_steps_per_trip=boxopt.ascent_steps / full.trips,
                     skips_batch_s=batch_s["plain"][0], equal_with_and_without_skips=same)
    fill = lambda r: max(int(g.db.count.max()) for g in r.state.groups)
    extra = {}
    if kind == "composite":
        extra = {name: _composite_summary(r) for name, r in (("plain", p), ("tuned", t))}
    if kind in OPTION_KINDS:
        check(runner.fleet == fleet_eligible(ac)
              and len(captured["selection"]) == len(captured["round4"]) == 1,
              f"{kind}: fleet {runner.fleet}, recorded {len(captured['selection'])} K2 and "
              f"{len(captured['round4'])} K3 calls")
        extra.update(fleet=runner.fleet, k1_launches_by_shape=shapes,
                     scale_range=[float(p.state.scal.scale.min()),
                                  float(p.state.scal.scale.max())])
    if kind == "host":
        extra.update(_host_summary(mop, [probe] + [r for _, r in results], trips, seconds,
                                   starts[0], ac, p))
    if kind == "exit_eps":
        hist = stage_counts["hist"].tolist()
        check(len(captured["qp_admm_exit"]) == 1 and shapes == {"nv3_m6": counts["qp_admm"]},
              f"exit_eps: recorded {len(captured['qp_admm_exit'])} exit calls, shapes {shapes}")
        extra.update(k1_stages_per_lane_hist=hist, k1_exit_eps=EXIT_EPS,
                     k1_mean_stages=sum(i * c for i, c in enumerate(hist)) / max(1, sum(hist)))
    else:
        check("hist" not in stage_counts, f"{kind}: K1's exit instance ran")
    if kind == "max_points":
        C = captured["round4"][0][0][0].shape[1]
        check(C == 116 and runner.solver.db_capacity == 56,
              f"max_points: K3 recorded at C={C}, capacity {runner.solver.db_capacity}")
        extra.update(k3_recorded_C=C)
    phase(f"{kind}_main_path", B=B_MAIN, dtype="float32", **budget,
          model={"taylor": "TaylorConfig(degree=2, mode='fd')",
                 "lagrange": "LagrangeConfig(degree=2)",
                 "composite": "make_composite(RbfConfig(kernel='cubic'))",
                 "scaler_model": "RbfConfig(kernel='multiquadric'), var_scaler_update='model'",
                 "no_db": "RbfConfig(kernel='multiquadric'), use_db=False",
                 "host": "RbfConfig(kernel='multiquadric'), NumPy objectives host=True, "
                         "can_batch=True",
                 "exit_eps": f"RbfConfig(kernel='multiquadric'), qp_exit_eps={EXIT_EPS}",
                 "max_points": "RbfConfig(kernel='multiquadric', use_max_points=True), "
                               "use_db=False"}.get(
                     kind, "RbfConfig(kernel='multiquadric')"),
          descent="PascolettiSerafiniConfig()" if kind == "ps" else "steepest_descent",
          **extra, launches=counts, trips_all_batches=trips,
          launches_per_trip={k: v / trips for k, v in counts.items()},
          ascent_steps_per_trip=ascent_steps / trips, **skips, seconds=seconds,
          probe_trips=probe.trips, trips={"plain": p.trips, "tuned": t.trips},
          stage_trips=list(t.stage_trips),
          db_capacity={"plain": plain.db_capacity, "tuned": runner.solver.db_capacity},
          db_rows={"plain": fill(p), "tuned": fill(t)},
          schedule=[s for s, _ in runner.schedule], widths=list(runner.widths),
          capacity_overflow=overflow, lanes_differing_plain_vs_tuned=flips,
          runs_per_s={k: len(v) * B_MAIN / sum(v) for k, v in batch_s.items()},
          batch_s=batch_s, stop_codes=_stop_codes(p),
          pareto_fraction_1e2=None if kind == "composite" else pareto_fraction(p.x),
          mean_iterations=float(p.n_iterations.double().mean()),
          mean_evals=float(p.n_evals.double().mean()))
    return counts, captured


def _host_summary(mop, runs, trips, seconds, x0, ac, plain_host):
    """The host path's tallies over every batch of its phase (``runs``, the
    probe first): host round trips a trip, rows a round trip, the seconds
    inside the user's functions and their share of the phase's wall time;
    the rows passed must equal the sum of the group's counters. Then the
    plain runner on the first starts with the objectives as torch functions
    (stop codes, iterations and evaluations equal lane by lane; x and fx
    equal to the bit, else the first lane that differs and the first leaf
    of its state that does) and with ``can_batch=False`` (equal results)."""
    from morbit_tpu_torch.models.configs import RbfConfig
    from morbit_tpu_torch.parallel.multistart import build_solver
    from morbit_tpu_torch.problems.synthetic import make_two_parabolas

    stats = [f.stats for f in mop.functions]
    counted = sum(int(r.state.groups[0].n_evals.sum()) for r in runs)
    for st in stats:
        check(st.rows["eval"] == counted and st.rows["fd"] == st.rows["restoration"] == 0,
              f"host rows {st.rows} against the group's counters {counted}")
    host_s = sum(st.seconds for st in stats)
    out = dict(host_round_trips=stats[0].round_trips,
               host_round_trips_per_trip=stats[0].round_trips / trips,
               host_rows_per_round_trip=stats[0].rows["eval"] / stats[0].round_trips,
               host_calls=[st.calls for st in stats], host_rows_eval=counted,
               host_user_seconds=host_s, host_user_share_of_wall=host_s / seconds)
    cuda = torch.device("cuda")

    def same(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("stop_code", "n_iterations", "n_evals"))
    torch_run = build_solver(make_two_parabolas(RbfConfig(kernel="multiquadric"), LB, UB),
                             ac, torch.float32, cuda).solve(x0)
    check(same(plain_host, torch_run), "the host path's stop codes, iterations or "
          "evaluations differ from the torch functions' run")
    bits = bool(torch.equal(plain_host.x, torch_run.x) and torch.equal(plain_host.fx,
                                                                      torch_run.fx))
    out["x_fx_equal_to_torch_run_bitwise"] = bits
    if not bits:
        lane = int(((plain_host.x != torch_run.x).any(-1)
                    | (plain_host.fx != torch_run.fx).any(-1)).nonzero()[0])
        out["first_lane_differing"] = dict(lane=lane, cause=family_part_cause(
            plain_host.state, torch_run.state, lane))
    single = host_parabolas(can_batch=False)
    t1 = time.perf_counter()
    one_by_one = build_solver(single, ac, torch.float32, cuda).solve(x0)
    out["can_batch_false_batch_s"] = time.perf_counter() - t1
    check(same(one_by_one, plain_host) and torch.equal(one_by_one.x, plain_host.x)
          and torch.equal(one_by_one.fx, plain_host.fx),
          "the can_batch=False batch differs from the can_batch=True batch")
    out["can_batch_false_calls"] = [f.stats.calls for f in single.functions]
    return out


def phase_family_card_vs_cpu(kind):
    """The Taylor, Lagrange or PS path at float64, 64 Halton starts, max_iter
    FAMILY_LOCKSTEP_ITERS, on the card and on the CPU trip by trip from the
    same state (``lockstep``): integer leaves equal, floats within 1e-9 +
    1e-6 |x|; only the recorded pairs of FAMILY_MAY_PART may part, each for
    its recorded cause."""
    from morbit_tpu_torch.problems.synthetic import halton_starts

    B = 64
    ac = family_config(kind, max_iter=FAMILY_LOCKSTEP_ITERS, qp_iters=QP_ITERS)
    recorded = FAMILY_MAY_PART[kind]
    trips, seconds, diffs, parted, _ = lockstep(
        lambda: family_mop(kind), halton_starts(B, LB, UB), ac, may_part=set(recorded),
        eligible=lambda st: np.ones(st.x.shape[0], bool), describe=family_part_cause)
    for pair, cause in parted.items():
        check(recorded.get(pair) == cause,
              f"{kind} lane {pair[1]} parted at trip {pair[0]} ({cause}); recorded: "
              f"{recorded.get(pair)}")
    phase(f"{kind}_card_vs_cpu", B=B, dtype="float64", max_iter=FAMILY_LOCKSTEP_ITERS,
          lockstep_trips=trips, lockstep_s=seconds,
          lockstep_rho_max_rel_diff=diffs["rho"], lockstep_fit_max_rel_diff=diffs["fit"],
          parted={f"{t},{i}": c for (t, i), c in parted.items()},
          may_part={f"{t},{i}": c for (t, i), c in recorded.items()})


def scaled_mop(lb, ub):
    """``examples/variable_scaling.py``'s badly scaled problem (x0 in units
    of 1, x1 in units of 1e4) on the box (lb, ub), one multiquadric group."""
    from morbit_tpu_torch import MOP
    from morbit_tpu_torch.models.configs import RbfConfig

    mop = MOP(lb, ub)
    cfg = RbfConfig(kernel="multiquadric")
    mop.add_objective(lambda x: (x[0] - 0.3) ** 2 + (x[1] / 1e4 - 0.3) ** 2, model_cfg=cfg)
    mop.add_objective(lambda x: (x[0] - 0.7) ** 2 + (x[1] / 1e4 - 0.7) ** 2, model_cfg=cfg)
    return mop


#: where ``optimize_surface`` writes its checkpoint (gitignored)
CHECKPOINT = ROOT / "build" / "optimize_surface_state.npz"


def _surface_runs(device, recycle=None):
    """The ``optimize`` surface at float64 on ``device``: a run of the main
    path's problem, a second from another start recycling its databases
    (``populated_db``), the same pair with ``untransform_final_database``,
    ``var_scaler='auto'`` on an unbounded variant of the badly scaled
    problem, and a checkpoint of a B=8 solve saved after three trips,
    loaded and resumed. The recycled runs take their databases from
    ``recycle`` (another device's runs) where given, so that both devices
    recycle the same bits. Returns the runs, the checkpoint's resumed and
    uninterrupted final states, and the recycled runs' first database rows."""
    from morbit_tpu_torch import AlgorithmConfig, optimize
    from morbit_tpu_torch.parallel.multistart import build_solver
    from morbit_tpu_torch.problems.synthetic import halton_starts, make_two_parabolas
    from morbit_tpu_torch.utils.checkpoint import load_state, save_state

    f64 = torch.float64
    kw = dict(device=device, dtype=f64, max_iter=20, qp_iters=QP_ITERS)
    runs = {"first": optimize(rbf_mop(), [-3.0, 2.5], **kw)}
    runs["untransformed"] = optimize(rbf_mop(), [-3.0, 2.5],
                                     untransform_final_database=True, **kw)
    prev = recycle or runs
    runs["recycled"] = optimize(rbf_mop(), [2.0, -3.0], populated_db=prev["first"], **kw)
    runs["recycled_untransformed"] = optimize(rbf_mop(), [2.0, -3.0],
                                              populated_db=prev["untransformed"], **kw)
    inf = [float("inf")] * 2
    runs["auto_unbounded"] = optimize(scaled_mop([-x for x in inf], inf), [0.9, 9.0e3],
                                      var_scaler="auto", **dict(kw, max_iter=30))
    # its estimate scales x1 by ~1.4e4 and the run stops after one
    # iteration (as the JAX package's does); the two parabolas without a
    # box take moderate factors and run on (exact objectives: without a
    # box, an RBF run's tied box exits part card and CPU, ROADMAP 3.4)
    runs["auto_parabolas"] = optimize(make_two_parabolas(), [-3.0, 2.5], var_scaler="auto",
                                      **kw)
    solver = build_solver(rbf_mop(), AlgorithmConfig(max_iter=30, qp_iters=QP_ITERS), f64,
                          device)
    x0 = halton_starts(8, LB, UB)
    state = solver.initialize(x0)
    for _ in range(3):
        state = solver.iterate(state)
    CHECKPOINT.parent.mkdir(parents=True, exist_ok=True)
    save_state(str(CHECKPOINT), state)
    resumed, _ = solver.solve_from_state(load_state(str(CHECKPOINT), solver.initialize(x0)))
    whole, _ = solver.solve_from_state(state)
    first_rows = {k: int(runs[k].state.traj.x_indices[0, 0])
                  for k in ("recycled", "recycled_untransformed")}
    return runs, resumed, whole, first_rows


#: a number in a live line (integers, floats, inf and nan)
_NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:e[-+]?\d+)?|[-+]?inf|nan")


def live_lines(device):
    """The live lines of ``optimize(verbosity=4)`` on the main path's
    problem at float64 from (-3, 2.5), max_iter=20."""
    from morbit_tpu_torch import optimize

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        optimize(rbf_mop(), [-3.0, 2.5], device=device, dtype=torch.float64, max_iter=20,
                 qp_iters=QP_ITERS, verbosity=4)
    return [ln for ln in out.getvalue().splitlines() if ln.startswith(("| Iteration", "|  "))]


def same_live_lines(ours, theirs):
    """The same lines in the same order: the text between numbers equal,
    integers equal, floats within 1e-10 relative. Returns the first line
    pair that differs, or None."""
    if len(ours) != len(theirs):
        return (f"{len(ours)} lines", f"{len(theirs)} lines")
    for a, b in zip(ours, theirs):
        if _NUMBER.split(a) != _NUMBER.split(b):
            return a, b
        for u, v in zip(_NUMBER.findall(a), _NUMBER.findall(b)):
            if re.fullmatch(r"[-+]?\d+", v):
                if u != v:
                    return a, b
            elif not (u == v or abs(float(u) - float(v)) <= 1e-10 * abs(float(v))):
                return a, b
    return None


def phase_optimize_surface():
    """``optimize``'s options on the card at float64 (``_surface_runs``): the
    recycled runs start past the first run's database rows, the
    untransformed database holds unscaled sites under an identity scaler,
    'auto' estimates a scaler other than the identity, and the resumed
    checkpoint equals the uninterrupted solve to the bit. The same runs on
    the CPU must equal the card's: stop codes, iterations, evaluations and
    database fills exactly, x, fx and the scalers within 1e-9 + 1e-6 |x|.
    The CPU's recycled runs recycle the card's first runs: the two devices'
    first runs agree to rounding, not to the bit, and a recycled run's
    model rounds see the stored sites' last bits through exact ties (ROADMAP
    3.4)."""
    from morbit_tpu_torch.utils.checkpoint import tree_leaves

    t0 = time.perf_counter()
    out = {"cuda": _surface_runs("cuda")}
    out["cpu"] = _surface_runs("cpu", recycle=out["cuda"][0])
    seconds = time.perf_counter() - t0
    runs, resumed, whole, first_rows = out["cuda"]
    runs_cpu, _, _, first_rows_cpu = out["cpu"]
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed), tree_leaves(whole))),
          "the resumed checkpoint differs from the uninterrupted solve")
    check(first_rows == {"recycled": int(runs["first"].state.groups[0].db.count),
                         "recycled_untransformed": int(
                             runs["untransformed"].state.groups[0].db.count)},
          f"the recycled runs start at rows {first_rows}")
    un = runs["untransformed"]
    check(bool((un.state.scal.scale == 1).all() and (un.state.scal.offset == 0).all()),
          "untransform_final_database left a scaler other than the identity")
    db = un.state.groups[0].db
    check(float((db.X[int(un.state.x_indices[0])] - un.x).abs().max()) <= 1e-12,
          "the untransformed database's iterate row is not the iterate")
    auto_scale = {k: runs[k].state.scal.scale for k in ("auto_unbounded", "auto_parabolas")}
    check(not any(bool((v == 1).all()) for v in auto_scale.values()),
          "'auto' kept the identity on an unbounded box")

    def close(a, b):
        a = a.cpu()
        fin = torch.isfinite(b)
        return bool(torch.where(fin, (a - b).abs() <= 1e-9 + 1e-6 * b.abs(), a == b).all())
    summary = {}
    for name, r in runs.items():
        c = runs_cpu[name]
        same = (int(r.stop_code) == int(c.stop_code)
                and int(r.n_iterations) == int(c.n_iterations)
                and int(r.n_evals) == int(c.n_evals)
                and [int(g.db.count) for g in r.state.groups]
                == [int(g.db.count) for g in c.state.groups]
                and close(r.x, c.x) and close(r.fx, c.fx)
                and all(close(a, b) for a, b in zip(r.state.scal, c.state.scal)))
        if not same:
            print(json.dumps({"optimize_surface_differs": name, **{
                dev: dict(stop_code=int(v.stop_code), n_iterations=int(v.n_iterations),
                          n_evals=int(v.n_evals), x=v.x.tolist(), fx=v.fx.tolist(),
                          db_rows=[int(g.db.count) for g in v.state.groups],
                          it_stat=v.state.traj.it_stat[:int(v.state.traj.count)].tolist())
                for dev, v in (("cuda", r), ("cpu", c))}}), flush=True)
        check(same, f"optimize_surface {name}: the card's run differs from the CPU's")
        summary[name] = dict(stop_code=int(r.stop_code), n_iterations=int(r.n_iterations),
                             n_evals=int(r.n_evals), x=r.x.tolist(),
                             db_rows=int(r.state.groups[0].db.count))
    check(first_rows_cpu == first_rows, "the CPU's recycled runs start elsewhere")
    t0 = time.perf_counter()
    lines = {dev: live_lines(dev) for dev in ("cuda", "cpu")}
    log_s = time.perf_counter() - t0
    differs = same_live_lines(lines["cuda"], lines["cpu"])
    check(bool(lines["cuda"]) and differs is None,
          f"the card's live lines differ from the CPU's: {differs}")
    phase("optimize_surface", dtype="float64", runs=summary, recycled_first_rows=first_rows,
          live_log_lines=len(lines["cuda"]), live_log_equal=True, live_log_s=log_s,
          auto_scale={k: v.tolist() for k, v in auto_scale.items()},
          checkpoint_resumed_bit_equal=True,
          card_equals_cpu=True, seconds=seconds)


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
    trips, seconds, diffs, _, _ = lockstep(make, halton_starts(8, mop.lb, mop.ub), ac)
    phase("wide_card_vs_cpu", B=8, n=10, dtype="float64", max_iter=10,
          lockstep_trips=trips, lockstep_s=seconds,
          lockstep_rho_max_rel_diff=diffs["rho"], lockstep_fit_max_rel_diff=diffs["fit"])


def phase_wide50_card_vs_cpu():
    """ZDT1 at n=50 (cubic RBF, float64, B=4, max_iter=2) on the card and on
    the CPU, trip by trip from the same state (``lockstep``): K1's strided
    instance at (51, 102), K2's wide instance, K3's slot instance at
    max_points 1326 and the fit's k = 1377 solve at float64. Integer leaves
    must be equal on every lane and trip, or the phase fails; a lane whose
    floats part beyond ``_compare_states``' bounds is reported with its
    first parting leaf (``_compare_states``' report), as evidence of fault
    3.15 (the card's float64 library solves are not the CPU's), and is not
    held to a looser bound."""
    from morbit_tpu_torch import AlgorithmConfig
    from morbit_tpu_torch.problems.synthetic import halton_starts

    make = lambda: wide_mop(N_WIDE50)
    mop = make()
    ac = AlgorithmConfig(**dict(WIDE50_BUDGET, max_iter=2))
    B = 4
    every = {(t, i) for t in range(-1, ac.max_iter + 1) for i in range(B)}
    trips, seconds, diffs, parted, _ = lockstep(
        make, halton_starts(B, mop.lb, mop.ub), ac, may_part=every,
        eligible=lambda state: np.ones(B, bool),
        describe=lambda card, cpu, lane: _compare_states(card, cpu, np.ones(B, bool))[2][lane])
    ints = {f"{t},{i}": d["integer_leaves"] for (t, i), d in parted.items()
            if d["integer_leaves"]}
    phase("wide50_card_vs_cpu", B=B, n=N_WIDE50, dtype="float64", max_iter=ac.max_iter,
          lockstep_trips=trips, lockstep_s=seconds,
          lockstep_rho_max_rel_diff=diffs["rho"], lockstep_fit_max_rel_diff=diffs["fit"],
          parted=[{"trip": t, "lane": i, **d} for (t, i), d in sorted(parted.items())],
          integers_equal=not ints)
    check(not ints, f"wide50_card_vs_cpu: integer leaves differ (trip,lane: leaves) {ints}")


def gram_work(B, P, n, itemsize):
    """(operations, bytes) of one K4 call: per entry of the symmetric Gram's
    upper triangle (P (P + 1) / 2 of them; the rest are copies) 2n for the
    cross term and ~8 for r^2, phi and the select; the sites and mask read
    once, the (B, P, P) Gram written once."""
    return (B * P * (P + 1) // 2 * (2 * n + 8),
            B * P * n * itemsize + B * P + B * itemsize + B * P * P * itemsize)


def phase_kernel_gram(wide_captured, wide50_captured=()):
    """K4 against its twin on the card: B=1024 random cases at (P, n) =
    (134, 14) and (251, 20), all five kernels, B=128 cases at the edges of
    its tiling (P in 128, 129, 251, 512 and n in 1, 20, 32), ~70 % valid
    rows, and the inputs the wide path and the n=50 path (the tiled
    instance) gave it; max|diff| / max|Phi| within 1e-12 (float64) or 1e-5
    (float32), and the output exactly symmetric. On the n=50 call the twin
    runs the first ``WIDE50_TWIN_LANES`` lanes (its (B, 1326, 1326)
    temporaries do not fit the card at B=1024), the kernel all of them.
    Returns the rows of the wide path's last recorded call and of the n=50
    path's (float32)."""
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
    sets += [(f"wide50_path_call{t}", recorded(a))
             for t, (a, _) in zip(WIDE50_CAPTURE_CALLS, wide50_captured)]
    rows = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for name, make in sets:
            args = make(dtype)
            before = dense_kernels.gram_launches
            k = dense_kernels.rbf_gram_cuda(*args)
            L = WIDE50_TWIN_LANES if name.startswith("wide50") else args[0].shape[0]
            t_args = tuple(a[:L] if isinstance(a, torch.Tensor) and a.dim() else a
                           for a in args)
            t, plain_ms = timed(lambda: dense_kernels.rbf_gram_matrix_plain(*t_args))
            check(dense_kernels.gram_launches == before + 1, "K4 launch not counted")
            err = float((k[:L] - t).abs().max()) / float(t.abs().max())
            del t
            check(err <= tol, f"K4 {name} {dtype}: max|diff| / max|Phi| = {err} > {tol}")
            # only the tiles with I <= J are computed: the mirror is exact
            check(torch.equal(k, k.transpose(1, 2)), f"K4 {name} {dtype}: not symmetric")
            ms = event_ms(lambda: dense_kernels.rbf_gram_cuda(*args), 10, inner=10)
            B, P, n = args[0].shape
            ops, nbytes = gram_work(B, P, n, args[0].element_size())
            bound_ms, bound_by = bound(ops, nbytes, dtype)
            row = dict(set=name, dtype=str(dtype), B=B, P=P, n=n, kernel=args[2],
                       instance=dense_kernels.gram_plan(P, n, args[0].element_size()).instance,
                       twin_lanes=L, valid_rows=int(args[1].sum()), max_abs_err=err,
                       tol=tol, symmetric=True, ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       ops=ops, bytes=nbytes)
            phase("kernel_gram", **row)
            del k
            rows[name.split("_call")[0], dtype] = row
    return (rows[("wide_path", torch.float32)],
            rows.get(("wide50_path", torch.float32)))


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


# ---------------------------------------------- K6 and K7: lane-invariant f64

#: K6's and K7's batch widths at each shape (the small shapes at 1, 16 and
#: 1024 lanes, the n=50 path's fit at the 4 of ``wide50_card_vs_cpu``), and
#: the shape whose row the kernel table carries: the main path's fit at
#: float64 (k = 9: 6 sites and 3 polynomial terms, 2 objectives) at the 16
#: lanes of ``width_invariance_f64``
LANE_WIDTHS_SMALL, LANE_WIDTH_N50 = (1, 16, 1024), 4
LANE_TABLE_SHAPE = (9, 2, 16)


def _bits_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        (a.contiguous().view(torch.uint8) == b.contiguous().view(torch.uint8)).all())


def lane_lu_work(k, m, item):
    """(ops, bytes) of K6's factor and of its solve for one lane at (k, m):
    the factor's k(k-1)/2 divisions and 2 (k-1)k(2k-1)/6 multiplies and
    subtracts, reading A and writing LU, the permutation and info; the
    solve's m k (2k - 1), reading LU, the permutation and b and writing x."""
    factor = (k * (k - 1) // 2 + (k - 1) * k * (2 * k - 1) // 3,
              2 * k * k * item + 4 * k + 4)
    solve = (m * k * (2 * k - 1), k * k * item + 4 * k + 2 * k * m * item)
    return factor, solve


def lane_shapes(fit_k, polish_k, fit_m):
    """(k, m, B) of K6's and K7's kernel phases: each fit's k with ``fit_m``
    right-hand sides and each polish's K with one, at every width of
    ``LANE_WIDTHS_SMALL``; the largest fit at ``LANE_WIDTH_N50`` lanes."""
    *small, big = fit_k
    return ([(k, fit_m, B) for k in small for B in LANE_WIDTHS_SMALL]
            + [(big, fit_m, LANE_WIDTH_N50)]
            + [(k, 1, B) for k in polish_k for B in LANE_WIDTHS_SMALL])


def phase_kernel_lane_lu():
    """K6 (``csrc/lane_lu.cu``) against its twins on the card at float64:
    factor and solve at every shape of ``lane_shapes`` (the fits' k and the
    polish's K of ``width_gaps.py``), LU, permutation, info and x equal to
    the bit, the kernel's lanes of a batch against the twin's; card ms of
    each (median of event timings of its C launch repeated, without the
    wrapper's host work), the twins' ms (one run), the bound at
    the FP64 peak (``PEAK_FLOPS``: 67 TFLOP/s) and the library's ms on the
    same inputs (``lu_factor_ex``, ``lu_solve``, and ``solve_ex`` for both).
    Returns the rows of ``LANE_TABLE_SHAPE`` (factor, solve)."""
    from morbit_tpu_torch.ops import lane_linalg as ll
    from morbit_tpu_torch.tools.width_gaps import FIT_K, FIT_M, POLISH_K

    g = torch.Generator(device="cuda").manual_seed(17)
    table = None
    for k, m, B in lane_shapes(FIT_K, POLISH_K, FIT_M):
        A = torch.randn(B, k, k, dtype=torch.float64, device="cuda", generator=g)
        b = torch.randn(B, k, m, dtype=torch.float64, device="cuda", generator=g)
        before = (ll.lu_factor_launches, ll.lu_solve_launches)
        LU, perm, info = ll.lane_lu_factor_cuda(A)
        x = ll.lane_lu_solve_cuda(LU, perm, b)
        check((ll.lu_factor_launches, ll.lu_solve_launches) == (before[0] + 1, before[1] + 1),
              "K6 launches not counted")
        (LU_t, perm_t, info_t), factor_plain_ms = timed(lambda: ll.lane_lu_factor_plain(A))
        x_t, solve_plain_ms = timed(lambda: ll.lane_lu_solve_plain(LU_t, perm_t, b))
        apart = [name for name, a, t in (("LU", LU, LU_t), ("perm", perm, perm_t),
                                         ("info", info, info_t), ("x", x, x_t))
                 if not _bits_equal(a, t)]
        check(not apart, f"K6 at k={k}, m={m}, B={B}: {apart} differ from the twin's")
        lib = torch.linalg.solve_ex(A, b)[0]
        lib_LU, lib_piv, _ = torch.linalg.lu_factor_ex(A)
        (f_ops, f_bytes), (s_ops, s_bytes) = lane_lu_work(k, m, 8)
        rows = {}
        # the kernels' C launches repeated on their buffers (the wrappers'
        # host work left out), the library calls back to back
        reps, inner = (3, 1) if k > 600 else (10, 10 if k <= 153 else 2)
        for part, kernel, plain_ms, library, ops, nbytes in (
                ("factor", ll.factor_launcher(A, torch.empty_like(LU), torch.empty_like(perm),
                                              torch.empty_like(info)), factor_plain_ms,
                 lambda: torch.linalg.lu_factor_ex(A), f_ops, f_bytes),
                ("solve", ll.solve_launcher(LU, perm, b, torch.empty_like(b)), solve_plain_ms,
                 lambda: torch.linalg.lu_solve(lib_LU, lib_piv, b), s_ops, s_bytes)):
            bound_ms, bound_by = bound(B * ops, B * nbytes, torch.float64)
            rows[part] = dict(ms=event_ms(kernel, reps, inner), plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=event_ms(library, reps, inner), max_abs_err=0.0)
        solve_ex_ms = event_ms(lambda: torch.linalg.solve_ex(A, b), reps, inner)
        plan = ll.lu_factor_plan(k, 8)
        phase("kernel_lane_lu", k=k, m=m, B=B, dtype="float64", bitwise=True,
              factor_place=plan.instance, factor_smem_bytes=plan.smem_bytes,
              solve_place=ll.lu_solve_plan(k, m, 8).instance,
              singular_lanes=int((info != 0).sum()),
              max_rel_diff_from_solve_ex=float((x - lib).abs().max() / lib.abs().max()),
              solve_ex_ms=solve_ex_ms, **{f"{p}_{key}": v for p, r in rows.items()
                                           for key, v in r.items()})
        if (k, m, B) == LANE_TABLE_SHAPE:
            table = rows
    return table


def phase_kernel_lane_matmul():
    """K7 (``csrc/lane_matmul.cu``) against its twin on the card at
    float64: (B, k, k) @ (B, k, m) at every (k, B) of ``lane_shapes`` and m
    in ``PRODUCT_M``, equal to the bit; card ms (its C launch repeated) and
    the wrapper's (flattening, checks and launch: host-bound at small
    shapes), the twin's ms, the bound and ``torch.bmm``'s ms on the same
    inputs. Returns the row of
    ``LANE_TABLE_SHAPE``."""
    from morbit_tpu_torch.ops import lane_linalg as ll
    from morbit_tpu_torch.tools.width_gaps import FIT_K, FIT_M, POLISH_K, PRODUCT_M

    g = torch.Generator(device="cuda").manual_seed(18)
    table = None
    shapes = sorted({(k, B) for k, _, B in lane_shapes(FIT_K, POLISH_K, FIT_M)})
    for (k, B), m in ((kb, m) for kb in shapes for m in PRODUCT_M):
        a = torch.randn(B, k, k, dtype=torch.float64, device="cuda", generator=g)
        b = torch.randn(B, k, m, dtype=torch.float64, device="cuda", generator=g)
        before = ll.matmul_launches
        out = ll.lane_matmul_cuda(a, b)
        check(ll.matmul_launches == before + 1, "K7 launch not counted")
        want, plain_ms = timed(lambda: ll.lane_matmul_plain(a, b))
        check(_bits_equal(out, want), f"K7 at k={k}, m={m}, B={B} differs from the twin")
        bound_ms, bound_by = bound(2 * B * k * k * m, 8 * B * (k * k + 2 * k * m),
                                   torch.float64)
        row = dict(ms=event_ms(ll.matmul_launcher(a, b, torch.empty_like(out)), 10, inner=20),
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=event_ms(lambda: torch.bmm(a, b), 10, inner=20),
                   wrapper_ms=event_ms(lambda: ll.lane_matmul_cuda(a, b), 10, inner=20),
                   max_abs_err=0.0)
        phase("kernel_lane_matmul", k=k, m=m, B=B, dtype="float64", bitwise=True,
              max_abs_diff_from_bmm=float((out - torch.bmm(a, b)).abs().max()), **row)
        if (k, m, B) == LANE_TABLE_SHAPE:
            table = row
    return table


def _lane_launch_counts():
    from morbit_tpu_torch.ops import lane_linalg as ll

    return {"lane_lu_factor": ll.lu_factor_launches, "lane_lu_solve": ll.lu_solve_launches,
            "lane_matmul": ll.matmul_launches}


def _zero_lane_launch_counts():
    from morbit_tpu_torch.ops import lane_linalg as ll

    ll.lu_factor_launches = ll.lu_solve_launches = ll.matmul_launches = 0


def phase_width_invariance_f64():
    """The float64 path whose runs K6 and K7 make independent of the batch
    width (ROADMAP 3.15), under ``kernels_only``: ``width_gaps.py``'s
    problem (two parabolas, one multiquadric group, 16 Halton starts,
    max_iter=12, qp_iters=100) by the plain runner unsharded and over the
    meshes ``[cuda:0] * k``, k = 2, 4, 8, 16 (shards of 8, 4, 2 and 1
    lanes), and by ``StagedMultistart(schedule=(3, 6), widths=(16, 8, 8))``
    over a mesh of 4; each equal to the unsharded batch of 16 to the bit in
    every leaf after ``canonicalize_buffer_tails``. K6's and K7's counts are
    set to 0 just before the runs and read just after; each must have
    launched. Returns the counts."""
    from morbit_tpu_torch.tools.width_gaps import width_invariance

    t0 = time.perf_counter()
    with kernels_only():
        _zero_lane_launch_counts()
        runs = width_invariance("cuda")
        torch.cuda.synchronize()
        launches = _lane_launch_counts()
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the float64 path")
    for name, r in runs.items():
        check(not r["leaves_apart"], f"width_invariance_f64: {name} parts from the "
              f"batch of 16 in {r['leaves_apart']} (largest gap {r['largest_gap']})")
    phase("width_invariance_f64", B=16, dtype="float64", max_iter=12, qp_iters=100,
          runs=runs, launches=launches, seconds=time.perf_counter() - t0)
    return launches


# ------------------------------------------------- the compacted runner (slice 13)

#: interleaved rounds of the plain and the compacted runner per budget
COMPACTED_ROUNDS = 1
#: the f64 card check of the compacted runner: its budget, ladder, stage length
COMPACTED_EXACT = dict(B=64, max_iter=25, ladder=(64, 32, 16, 8), stage_iters=3)


def _integer_lanes_differing(res, ref):
    """Lanes whose stop code, iteration count or evaluations differ."""
    return ((res.stop_code != ref.stop_code) | (res.n_iterations != ref.n_iterations)
            | (res.n_evals != ref.n_evals)).nonzero().flatten().tolist()


def phase_compacted_main_path():
    """The main path (two parabolas, one multiquadric group, f32, B=1024,
    Halton starts) at both budgets of STAGED_BUDGETS, run by
    ``CompactedMultistart`` with its default ladder (1024, 512, 256, 128, 64)
    and ``stage_iters=10``, and by the plain ``multistart_optimize`` in turns
    on distinct starts, under ``kernels_only``. The counts are set to 0 just
    before each batch and read just after it. Each compacted batch must
    equal the plain batch on the same starts lane by lane (stop code,
    iterations and evaluations exactly; x and fx reported: the largest
    difference and the lanes equal to the bit). Returns the launches of
    the first compacted batch at each budget."""
    from morbit_tpu_torch import AlgorithmConfig, CompactedMultistart, multistart_optimize
    from morbit_tpu_torch.problems.synthetic import halton_starts
    from morbit_tpu_torch.tools.profile_main_path import stage_log

    cuda = torch.device("cuda")
    out = []
    for budget in STAGED_BUDGETS:
        ac = AlgorithmConfig(**budget)
        mop = rbf_mop()
        runner = CompactedMultistart(mop, ac, torch.float32, stage_iters=10)
        batch_s = {"plain": [], "compacted": []}
        launches = {"plain": [], "compacted": []}
        stages, rows = [], []
        t0 = time.perf_counter()
        for k in range(COMPACTED_ROUNDS):
            x0 = torch.as_tensor(halton_starts(B_MAIN, LB, UB, 1 + k * B_MAIN),
                                 dtype=torch.float32, device=cuda)
            res = {}
            for name, run in (("plain", lambda x: multistart_optimize(mop, x, ac)),
                              ("compacted", runner)):
                log = []
                torch.cuda.synchronize()
                _zero_all_launch_counts()
                t1 = time.perf_counter()
                with kernels_only(), stage_log(log):
                    res[name] = run(x0)
                    torch.cuda.synchronize()
                batch_s[name].append(time.perf_counter() - t1)
                counts = _all_launch_counts()
                launches[name].append(counts)
                for kname in ("qp_admm", "rbf_selection", "rbf_round4"):
                    check(counts[kname] >= res[name].trips,
                          f"{kname} launched {counts[kname]} times in {res[name].trips} "
                          f"trips of the {name} runner")
                _check_result(res[name], B_MAIN)
                if name == "compacted":
                    stages.append(log)
            p, c = res["plain"], res["compacted"]
            lanes = _integer_lanes_differing(c, p)
            check(not lanes, f"compacted vs plain at {budget}: lanes {lanes[:16]} differ")
            dx = (c.x - p.x).abs().amax(-1)
            dfx = (c.fx - p.fx).abs().amax(-1)
            check(bool(torch.isfinite(dx).all() and torch.isfinite(dfx).all()),
                  "non-finite x or fx difference between the compacted and plain runners")
            rows.append(dict(trips={"plain": p.trips, "compacted": c.trips},
                             stage_trips=list(c.stage_trips),
                             stage_buckets=[w for w, *_ in stages[-1]],
                             max_abs_dx=float(dx.max()), max_abs_dfx=float(dfx.max()),
                             lanes_x_fx_equal_bitwise=int(((dx == 0) & (dfx == 0)).sum())))
        first = launches["compacted"][0]
        phase("compacted_main_path", B=B_MAIN, dtype="float32", **budget,
              model="RbfConfig(kernel='multiquadric')", stage_iters=10,
              ladder=[B_MAIN >> s for s in range(5)], batches=rows,
              lanes_differing_plain_vs_compacted=0,
              runs_per_s={k: len(v) * B_MAIN / sum(v) for k, v in batch_s.items()},
              batch_s=batch_s, launches_per_batch=launches,
              k1_k3_launches_per_batch={
                  name: {k: [b[k] for b in v] for k in ("qp_admm", "rbf_selection",
                                                         "rbf_round4")}
                  for name, v in launches.items()},
              stop_codes=_stop_codes(c), mean_iterations=float(c.n_iterations.double().mean()),
              seconds=time.perf_counter() - t0)
        out.append(first)
    return out


def phase_compacted_card_exact():
    """At float64, B=64 Halton starts, max_iter=25, ladder (64, 32, 16, 8),
    ``stage_iters=3``: the compacted runner on the card against the plain
    runner on the card, every leaf of the state (integers exact, floats
    within 1e-12), and the compacted runner on the CPU against the plain
    runner on the CPU (every integer leaf equal). Card and CPU free runs
    part on some lanes by the rounding of plain operations met at exact
    ties (ROADMAP 3.4; ``rbf_card_vs_cpu`` holds them trip by trip): the
    lanes where the compacted runs part card from CPU must be those where
    the plain runs do."""
    from morbit_tpu_torch import AlgorithmConfig, CompactedMultistart, multistart_optimize
    from morbit_tpu_torch.problems.synthetic import halton_starts
    from morbit_tpu_torch.tools.profile_main_path import stage_log
    from morbit_tpu_torch.utils.carry import state_to_numpy

    cfg = COMPACTED_EXACT
    B = cfg["B"]
    ac = AlgorithmConfig(max_iter=cfg["max_iter"], qp_iters=QP_ITERS)
    x0 = halton_starts(B, LB, UB)
    t0 = time.perf_counter()
    ref = multistart_optimize(rbf_mop(), x0, ac, dtype=torch.float64)
    ref_cpu = multistart_optimize(rbf_mop(), x0, ac, dtype=torch.float64, device="cpu")
    runs, logs = {}, {}
    for dev in ("cuda", "cpu"):
        logs[dev] = []
        with stage_log(logs[dev]):
            runs[dev] = CompactedMultistart(rbf_mop(), ac, torch.float64,
                                            stage_iters=cfg["stage_iters"],
                                            bucket_ladder=cfg["ladder"], device=dev)(x0)
    card, cpu = runs["cuda"], runs["cpu"]
    a, b = state_to_numpy(card.state), state_to_numpy(ref.state)
    worst = 0.0
    for name in b:
        va, vb = a[name], b[name]
        check(va.dtype == vb.dtype and va.shape == vb.shape, f"{name}: dtype or shape")
        if va.dtype.kind in "biu":
            check(np.array_equal(va, vb), f"compacted vs plain on the card: {name} differs")
            continue
        check(np.array_equal(np.isfinite(va), np.isfinite(vb)),
              f"compacted vs plain on the card: {name} non-finite entries differ")
        fin = np.isfinite(vb)
        d = float(np.max(np.abs(va[fin] - vb[fin]), initial=0.0))
        check(d <= 1e-12, f"compacted vs plain on the card: {name} differs by {d}")
        worst = max(worst, d)
    for name in ("stop_code", "n_iterations", "n_evals"):
        check(bool(torch.equal(getattr(card, name), getattr(ref, name))), f"{name} differs")
    def integer_lanes(u, v):
        return sorted({int(i) for name in u if u[name].dtype.kind in "biu"
                       for i in np.nonzero((u[name] != v[name]).reshape(B, -1).any(-1))[0]})
    c, c_ref = state_to_numpy(cpu.state), state_to_numpy(ref_cpu.state)
    on_cpu = integer_lanes(c, c_ref)
    check(not on_cpu, f"compacted vs plain on the CPU: lanes {on_cpu[:16]} differ")
    compacted_apart, plain_apart = integer_lanes(a, c), integer_lanes(b, c_ref)
    check(compacted_apart == plain_apart,
          f"the compacted runs part card from CPU on lanes {compacted_apart}, the plain "
          f"runs on {plain_apart}")
    phase("compacted_card_exact", B=B, dtype="float64", max_iter=cfg["max_iter"],
          ladder=list(cfg["ladder"]), stage_iters=cfg["stage_iters"],
          plain_trips=ref.trips, trips=card.trips, stage_trips=list(card.stage_trips),
          stage_buckets=[w for w, *_ in logs["cuda"]],
          stage_buckets_cpu=[w for w, *_ in logs["cpu"]],
          max_abs_float_diff_vs_plain=worst, integer_lanes_differing_vs_plain_on_cpu=0,
          lanes_card_vs_cpu_apart=compacted_apart,
          lanes_card_vs_cpu_apart_plain_runner=plain_apart,
          seconds=time.perf_counter() - t0)


# ------------------------------------------------ the benchmark grid (slice 13)

#: the settings the grid runs beside the harness's default grid, each by
#: one ``perform_test`` call without the steady-state call (to save time),
#: with its ``staged`` flag: K4 (an RBF of (16 * 17) / 2 = 136 >= 128 sites
#: at n = 15), a DTLZ problem, and Pascoletti-Serafini through the staged
#: runner (``tools/bench_grid_r5.py``'s first row)
GRID_EXTRA = ((("zdt1", 15, "rbf_cubic", "steepest_descent", 8), False),
              (("dtlz1", 5, "rbf_cubic", "steepest_descent", 8), False),
              (("zdt1", 10, "rbf_cubic", "ps", 8), True))
#: budget overrides of GRID_EXTRA's settings: the n = 15 row at max_iter=20
#: (K4 runs from its first fit; the whole budget took ~35 s)
GRID_EXTRA_OVERRIDES = {"zdt1-n15-rbf_cubic-steepest_descent-s8": dict(max_iter=20)}
#: settings of the default grid left out of grid_main_path to keep the
#: script within its time, each named in its output and in PERF.md: the
#: n=10 Lagrange-2 rows (~130 s each with the steady-state call), the n=10
#: Lagrange-1 rows (~32 s), the n=10 RBF rows (~50 s), the n=5 RBF and
#: Lagrange-2 rows (~23-35 s), ZDT2's and ZDT3's n=5 Lagrange-1 rows (~10 s)
#: and ZDT3's n=2 Lagrange rows (~12-19 s); every family keeps rows at n=2,
#: Lagrange-1 ZDT1's at n=5, Taylor-1 all nine (NVIDIA H100 80GB HBM3,
#: 700 W)
GRID_CUTS = tuple(
    [f"zdt{k}-n10-{m}-steepest_descent-s8"
     for m in ("lagrange2", "lagrange1", "rbf_cubic") for k in (1, 2, 3)]
    + [f"zdt{k}-n5-{m}-steepest_descent-s8"
       for m in ("rbf_cubic", "lagrange1", "lagrange2") for k in (2, 3)]
    + ["zdt1-n5-lagrange2-steepest_descent-s8", "zdt1-n5-rbf_cubic-steepest_descent-s8",
       "zdt3-n2-lagrange1-steepest_descent-s8", "zdt3-n2-lagrange2-steepest_descent-s8"])
#: where grid_main_path saves its results (and resumes from)
GRID_SAVE = ROOT / "build" / "grid_main_path.json"
#: fault 3.14's grid setting (cut from the timed grid above), run once by
#: grid_main_path: at a box corner round 3 can hold one site several times,
#: and such a training set fits non-finitely in the port exactly where it
#: does in the JAX package (tests/test_torch_zdt2_f32.py)
ZDT2_F32 = ("zdt2", 10, "rbf_cubic", "steepest_descent", 8)
#: the lanes of ZDT2_F32 whose omega may end non-finite on the card, each
#: with its record in ZDT2_F32_NAN_FITS: the card's state before the lane's
#: first non-finite fit and after it (``tools/nan_fit_states.py``, NVIDIA
#: H100 80GB HBM3, 700 W), and the JAX package's trip from that state, which
#: fits non-finitely too (``tests/test_torch_zdt2_f32.py``). Such a lane
#: must end with the recorded state's integer leaves.
ZDT2_F32_MAY_NAN = {3: "card_lane3"}
ZDT2_F32_NAN_FITS = ROOT / "tests" / "golden" / "zdt2_n10_rbf_cubic_f32_nan_fits.npz"
#: the settings grid_card_vs_cpu runs on the card and on the CPU, with their
#: budget overrides
GRID_CARD_VS_CPU = ((("two_parabolas", 2, "exact", "steepest_descent", 3),
                     dict(max_iter=6, qp_iters=100)),
                    (("zdt1", 2, "taylor1", "steepest_descent", 4), {}),
                    (("zdt1", 5, "rbf_cubic", "steepest_descent", 4), {}))
#: lanes of grid_card_vs_cpu recorded beyond 1e-10 apart, by setting key:
#: lane -> (its bound, the property (ROADMAP) that parts it). The bound is
#: the lane's largest float gap in three card runs (NVIDIA H100 80GB HBM3,
#: 700 W), which read the same to the bit, rounded up; its integers stay
#: exact, and ``lockstep`` names the first trip where it parts beyond the
#: lockstep standard (1e-9 + 1e-6 |x|), if any
GRID_MAY_PART = {
    # qp_iters=100 leaves the first descent LP unconverged, and the card's
    # and the CPU's polish take the two sides of its discontinuity (3.5):
    # the largest gap is fx's, 8.11e-10 (the CPU port ends as far from JAX)
    "two_parabolas-n2-exact-steepest_descent-s3": {1: (1e-9, "3.5 polish")},
    # the rounding of the card's plain operations, carried over the run's
    # trips (3.4): the largest gap 3.77e-10
    "zdt1-n5-rbf_cubic-steepest_descent-s4": {1: (5e-10, "3.4 rounding")},
}


#: documented partings of grid_card_vs_cpu, by setting key: lane -> (the
#: trip, the leaf, the ROADMAP entry). Such a lane, whose run carries a
#: rounding of one ulp past its GRID_MAY_PART bound by itself
#: (tests/test_torch_grid_lane_sensitivity.py), may end past that bound only
#: where its integers are exact, its widest gap is in the recorded leaf, and
#: the lockstep (one trip from the CPU's state on each device,
#: ``tools/card_cpu_gaps.lockstep``) parts it past 1e-10 at the recorded
#: trip and at no other
GRID_PARTINGS = {
    # trip 3 alone parts it: 2.505e-10 in fx (the library's solves and
    # products: 1.763e-9); every other trip within 2.5e-12 (3.20; NVIDIA
    # H100 80GB HBM3, 700 W)
    "zdt1-n5-rbf_cubic-steepest_descent-s4": {1: (3, "fx", "3.20")},
}


def documented_parting(setting, over, lane, widest):
    """Whether ``lane`` of ``setting`` parts card from CPU as its
    GRID_PARTINGS record says, and the lane's one-trip gaps by trip."""
    from morbit_tpu_torch.parallel.multistart import build_solver
    from morbit_tpu_torch.tools import card_cpu_gaps

    trip, leaf, _ = GRID_PARTINGS[setting.key][lane]
    s, mop, starts, ac = card_cpu_gaps._setup(dataclasses.astuple(setting), over)
    solvers = {d: build_solver(mop(), ac, torch.float64, d) for d in ("cuda", "cpu")}
    rows, _ = card_cpu_gaps.lockstep(solvers, starts, lane)
    gaps = {r["trip"]: r["gap"] for r in rows}
    ok = (widest.get("leaf") == leaf and gaps.get(trip, 0.0) > 1e-10
          and all(g <= 1e-10 for t, g in gaps.items() if t != trip)
          and not any(r.get("integers_apart") for r in rows))
    return ok, gaps


@contextlib.contextmanager
def per_setting_launches(log):
    """Set K1-K4's counts to 0 just before each ``perform_test`` of the
    harness and record them just after it, by setting key, in ``log``."""
    from morbit_tpu_torch.parallel import benchmarks

    inner = benchmarks.perform_test

    def wrapped(setting, *args, **kw):
        torch.cuda.synchronize()
        _zero_all_launch_counts()
        try:
            return inner(setting, *args, **kw)
        finally:
            torch.cuda.synchronize()
            log[setting.key] = _all_launch_counts()
    with mock.patch.object(benchmarks, "perform_test", wrapped):
        yield


def _check_grid_entry(key, obs, n_starts, n_vars):
    """One setting's observations: no ``error``, final stop codes, finite
    fx and omega, x of shape (starts, n)."""
    from morbit_tpu_torch import STOP_CODE

    check("error" not in obs, f"{key}: {obs.get('error')}")
    codes = np.asarray(obs["stop_code"])
    check(bool(((codes >= STOP_CODE.MAX_ITER) & (codes <= STOP_CODE.INFEASIBLE)).all()),
          f"{key}: a stop code that is not final, {codes.tolist()}")
    check(bool(np.isfinite(obs["fx"]).all() and np.isfinite(obs["omega"]).all()),
          f"{key}: non-finite fx or omega")
    check(np.asarray(obs["x"]).shape == (n_starts, n_vars), f"{key}: x's shape")
    return {STOP_CODE(c).name: int((codes == c).sum()) for c in np.unique(codes)}


def phase_grid_main_path():
    """``run_benchmarks(generate_all_settings(), steady_state=True)`` at
    float32 on the card (the harness's default grid: zdt1-3 x n in {2, 5,
    10} x {rbf_cubic, taylor1, lagrange1, lagrange2} x steepest descent, 8
    starts) less GRID_CUTS, saving to GRID_SAVE, and ``perform_test`` on
    each GRID_EXTRA setting, under ``kernels_only``. Fails on an ``error``
    entry, on a stop code that is not final and on a non-finite fx or
    omega; one line per setting. A second ``run_benchmarks`` on the same
    file must run no setting (no launch) and return the same entries.
    Returns the launches of all the settings."""
    from morbit_tpu_torch.parallel import benchmarks
    from morbit_tpu_torch.parallel.benchmarks import Setting, generate_all_settings

    GRID_SAVE.parent.mkdir(parents=True, exist_ok=True)
    GRID_SAVE.unlink(missing_ok=True)
    grid = [s for s in generate_all_settings() if s.key not in GRID_CUTS]
    extra = [(Setting(*key), staged) for key, staged in GRID_EXTRA]
    launches = {}
    t0 = time.perf_counter()
    with kernels_only(), per_setting_launches(launches):
        results = benchmarks.run_benchmarks(grid, save_path=str(GRID_SAVE),
                                            steady_state=True, verbose=False)
        extra_obs = {s.key: benchmarks.perform_test(
            s, staged=staged, **GRID_EXTRA_OVERRIDES.get(s.key, {}))
                     for s, staged in extra}
    seconds = time.perf_counter() - t0
    observed = {**results, **extra_obs}
    for s, staged in [(s, False) for s in grid] + extra:
        obs = observed[s.key]
        codes = _check_grid_entry(s.key, obs, s.n_starts, s.n_vars)
        phase("grid_setting", key=s.key, staged=staged, wall_s=obs["wall_s"],
              steady_state_s=obs.get("steady_state_s"),
              steady_runs_per_sec=obs.get("steady_runs_per_sec"),
              mean_n_evals=float(np.mean(obs["n_evals"])),
              mean_n_iterations=float(np.mean(obs["n_iterations"])),
              stop_codes=codes, launches=launches[s.key])
    # the resume: no setting runs again, and the entries are the file's
    again_launches = {}
    torch.cuda.synchronize()
    _zero_all_launch_counts()
    with per_setting_launches(again_launches):
        again = benchmarks.run_benchmarks(grid, save_path=str(GRID_SAVE),
                                          steady_state=True, verbose=False)
    relaunched = sum(_all_launch_counts().values())
    check(not again_launches and relaunched == 0,
          f"the resumed grid ran {sorted(again_launches)} ({relaunched} launches)")
    check(again == results == json.loads(GRID_SAVE.read_text()),
          "the resumed grid's entries differ from the first run's")
    launches[Setting(*ZDT2_F32).key] = grid_zdt2_f32()
    total = {k: sum(v[k] for v in launches.values()) for k in _all_launch_counts()}
    check(total["rbf_gram"] > 0, "K4 did not launch on the grid")
    phase("grid_main_path", dtype="float32", settings=len(grid) + len(extra),
          default_grid_settings=len(grid), cuts=list(GRID_CUTS),
          extra=[s.key + (" (staged)" if staged else "") for s, staged in extra],
          seconds=seconds, launches=total, resumed_settings_run=len(again_launches),
          resumed_launches=relaunched, save_file=str(GRID_SAVE.relative_to(ROOT)))
    return total


def grid_zdt2_f32():
    """ZDT2_F32 as ``perform_test`` runs it (the plain runner on its 8
    Halton starts, the reference budget, float32), under ``kernels_only``:
    final stop codes, fx finite on every lane, and omega finite but on the
    lanes of ZDT2_F32_MAY_NAN, each ending with the integer leaves of its
    recorded state (ROADMAP 3.14). Prints a ``grid_setting`` line; returns
    its K1-K4 launches."""
    from morbit_tpu_torch import STOP_CODE, multistart_optimize
    from morbit_tpu_torch.parallel.benchmarks import Setting, _default_config, make_problem
    from morbit_tpu_torch.problems.synthetic import halton_starts
    from morbit_tpu_torch.tools.nan_fit_states import fit_non_finite
    from morbit_tpu_torch.utils.carry import state_to_numpy

    s = Setting(*ZDT2_F32)
    mop = make_problem(s.problem, s.n_vars, s.model)
    x0 = torch.as_tensor(halton_starts(s.n_starts, mop.lb, mop.ub), dtype=torch.float32,
                         device="cuda")
    torch.cuda.synchronize()
    _zero_all_launch_counts()
    t0 = time.perf_counter()
    with kernels_only():
        res = multistart_optimize(mop, x0, _default_config(s), dtype=torch.float32)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _all_launch_counts()
    traj = res.state.traj
    omega = traj.omega[torch.arange(s.n_starts, device="cuda"),
                       (traj.count.long() - 1).clamp(min=0)].cpu().numpy()
    codes = res.stop_code.cpu().numpy()
    check(bool(((codes >= STOP_CODE.MAX_ITER) & (codes <= STOP_CODE.INFEASIBLE)).all()),
          f"{s.key}: a stop code that is not final, {codes.tolist()}")
    check(bool(torch.isfinite(res.fx).all()), f"{s.key}: non-finite fx")
    open_omega = np.nonzero(~np.isfinite(omega))[0].tolist()
    check(set(open_omega) <= set(ZDT2_F32_MAY_NAN),
          f"{s.key}: non-finite omega on lanes {open_omega}; recorded lanes "
          f"{sorted(ZDT2_F32_MAY_NAN)}")
    if open_omega:
        recorded = np.load(ZDT2_F32_NAN_FITS)
        final = state_to_numpy(res.state)
        for lane in open_omega:
            tag = ZDT2_F32_MAY_NAN[lane]
            apart = [k for k, a in final.items() if a.dtype.kind in "biu"
                     and not np.array_equal(a[lane:lane + 1], recorded[f"{tag}/port_after/{k}"])]
            check(not apart, f"{s.key}: lane {lane} ends with a non-finite omega away from "
                  f"its recorded state ({tag}): {apart}")
    phase("grid_setting", key=s.key, staged=False, wall_s=seconds,
          stop_codes={STOP_CODE(c).name: int((codes == c).sum()) for c in np.unique(codes)},
          n_iterations=res.n_iterations.tolist(), n_evals=res.n_evals.tolist(),
          omega_finite_lanes=int(np.isfinite(omega).sum()),
          non_finite_omega_lanes=open_omega,
          non_finite_fit_lanes=np.nonzero(fit_non_finite(res.state))[0].tolist(),
          launches=launches)
    return launches


def phase_grid_card_vs_cpu():
    """``perform_test`` at float64 on the card and on the CPU on the
    GRID_CARD_VS_CPU settings: integers exact, floats within 1e-10; the
    lanes of GRID_MAY_PART within their own bounds, and a lane of
    GRID_PARTINGS past its bound only as its record says
    (``documented_parting``). Where a lane is recorded or parts,
    ``lockstep`` runs the setting trip by trip and names each lane's first
    trip beyond the lockstep standard with the cause ``family_part_cause``
    finds, or none."""
    from morbit_tpu_torch.parallel import benchmarks
    from morbit_tpu_torch.parallel.benchmarks import Setting, _default_config, make_problem
    from morbit_tpu_torch.problems.synthetic import halton_starts

    rows = {}
    for key, over in GRID_CARD_VS_CPU:
        s = Setting(*key)
        t0 = time.perf_counter()
        obs = {dev: benchmarks.perform_test(s, dtype=torch.float64, device=dev, **over)
               for dev in ("cuda", "cpu")}
        recorded = GRID_MAY_PART.get(s.key, {})
        bounds = np.full(s.n_starts, 1e-10)
        for lane, (tol, _) in recorded.items():
            bounds[lane] = tol
        apart = np.zeros(s.n_starts, bool)
        ints_apart = np.zeros(s.n_starts, bool)     # integers or finiteness apart
        lane_gap = np.zeros(s.n_starts)
        widest = {}                 # lane -> its largest gap's leaf and values
        for k in ("x", "fx", "n_evals", "n_iterations", "stop_code", "omega"):
            a, b = obs["cuda"][k], obs["cpu"][k]
            if a.dtype.kind in "iu":
                bad = (a != b).reshape(s.n_starts, -1).any(-1)
                ints_apart |= bad
            else:
                both = np.isfinite(a) & np.isfinite(b)
                gaps = np.where(both, np.abs(a - b), 0.0).reshape(s.n_starts, -1)
                d = gaps.max(-1)
                bad = (np.isfinite(a) != np.isfinite(b)).reshape(s.n_starts, -1).any(-1)
                ints_apart |= bad
                bad |= d > bounds
                for i in np.nonzero((d > 1e-10) & (d > lane_gap))[0]:
                    j = int(gaps[i].argmax())
                    widest[int(i)] = {"leaf": k, "entry": j,
                                      "card": float(a.reshape(s.n_starts, -1)[i, j]),
                                      "cpu": float(b.reshape(s.n_starts, -1)[i, j])}
                lane_gap = np.maximum(lane_gap, d)
            apart |= bad
        partings = {}
        for lane in GRID_PARTINGS.get(s.key, {}):
            if apart[lane] and not ints_apart[lane]:
                ok, trip_gaps = documented_parting(s, over, lane, widest.get(lane, {}))
                partings[lane] = {"as_recorded": ok, "one_trip_gaps": trip_gaps}
                apart[lane] = not ok
        first_parting = {}
        if recorded or apart.any():
            mop = lambda: make_problem(s.problem, s.n_vars, s.model)
            starts = halton_starts(s.n_starts, mop().lb, mop().ub)
            _, _, _, pairs, _ = lockstep(mop, starts, _default_config(s, **over),
                                         may_part=[(t, i) for t in range(1000)
                                                   for i in range(s.n_starts)],
                                         eligible=lambda st: np.ones(st.x.shape[0], bool),
                                         describe=family_part_cause)
            for (t, i), cause in sorted(pairs.items()):
                first_parting.setdefault(i, f"trip {t}: {cause}")
        check(not apart.any(), f"{s.key}: lanes {np.nonzero(apart)[0].tolist()} part card "
              f"from CPU (first trips {first_parting}; partings {partings}); "
              f"recorded: {recorded}")
        rows[s.key] = dict(
            overrides=over, max_abs_float_diff=float(lane_gap.max()),
            lanes_beyond_1e10={int(i): dict(gap=float(lane_gap[i]), **widest[int(i)])
                               for i in np.nonzero(lane_gap > 1e-10)[0]},
            recorded={i: {"bound": tol, "cause": cause,
                          "lockstep": first_parting.get(
                              i, "none beyond the lockstep standard")}
                      for i, (tol, cause) in recorded.items()},
            documented_partings={i: {"record": GRID_PARTINGS[s.key][i], **v}
                                 for i, v in partings.items()},
            seconds=time.perf_counter() - t0)
    phase("grid_card_vs_cpu", dtype="float64", settings=rows)


# ------------------------------------- parametric runner and the mesh (slice 14)

#: the seed of the parametric path's per-lane centres (one stream a batch)
PARAMETRIC_SEED = 0
#: (trip, lane) pairs of parametric_card_vs_cpu that may part: none
PARAMETRIC_MAY_PART = {}
#: the mesh of mesh_main_path: four shards of the batch on the one card
MESH = ("cuda:0",) * 4


def parametric_thetas(B, batch):
    """The centres theta_i of one batch, (B, 2) uniform in [0.5, 2.5]."""
    return np.random.default_rng(PARAMETRIC_SEED + batch).uniform(0.5, 2.5, (B, 2))


def segment_share(x, theta, tol=0.3):
    """The share of lanes within ``tol`` of their own Pareto segment
    {s theta_i : s in [-1, 1]} (the check of the JAX package's
    tests/test_parametric.py:37-47, here a gauge)."""
    x, th = np.asarray(x, float), np.asarray(theta, float)
    s = np.clip((x * th).sum(-1) / (th * th).sum(-1), -1.0, 1.0)
    return float(np.mean(np.linalg.norm(x - s[:, None] * th, axis=-1) < tol))


def phase_parametric_main_path():
    """``parametric_multistart`` at full width beside the plain main path:
    counts set to 0 just before the parametric warm-up batch and read just
    after (each of K1-K3 at least once a trip); then the plain runner's
    warm-up, and one timed batch of each on new starts and centres."""
    from morbit_tpu_torch import AlgorithmConfig, multistart_optimize, parametric_multistart
    from morbit_tpu_torch.problems.synthetic import build_shifted, halton_starts

    ac = AlgorithmConfig(max_iter=100, qp_iters=QP_ITERS)
    starts = [torch.as_tensor(halton_starts(B_MAIN, LB, UB, 1 + k * B_MAIN),
                              dtype=torch.float32, device="cuda") for k in range(2)]
    thetas = [parametric_thetas(B_MAIN, k) for k in range(2)]
    run = lambda k: parametric_multistart(build_shifted, starts[k], thetas[k], ac,
                                          torch.float32)
    plain = lambda k: multistart_optimize(rbf_mop(), starts[k], ac, dtype=torch.float32)
    torch.cuda.synchronize()
    _zero_launch_counts()
    t0 = time.perf_counter()
    with kernels_only():
        warm = run(0)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        launches = _launch_counts()
        plain(0)
        seconds = {}
        for name, fn in (("parametric", run), ("plain", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(1)
            torch.cuda.synchronize()
            seconds[name] = (time.perf_counter() - t0, out)
    for name, count in launches.items():
        check(count >= warm.trips, f"{name} launched {count} times in {warm.trips} trips")
    _check_result(warm, B_MAIN)
    (theta_leaf,) = warm.state.theta
    check(theta_leaf.is_cuda and torch.equal(theta_leaf.cpu(), torch.as_tensor(
        thetas[0], dtype=torch.float32)), "the state's theta is not the lanes' centres")
    timed, timed_s = seconds["parametric"][1], seconds["parametric"][0]
    ref, ref_s = seconds["plain"][1], seconds["plain"][0]
    _check_result(timed, B_MAIN)
    phase("parametric_main_path", B=B_MAIN, dtype="float32", max_iter=100, qp_iters=QP_ITERS,
          problem="build_shifted, theta_i ~ U[0.5, 2.5]^2", launches=launches,
          trips=warm.trips, warmup_s=warm_s, runs_per_s=B_MAIN / timed_s,
          timed_trips=timed.trips, plain_runs_per_s=B_MAIN / ref_s, plain_trips=ref.trips,
          segment_share_0_3=segment_share(timed.x.cpu(), thetas[1]),
          mean_evals=float(timed.n_evals.double().mean()), stop_codes=_stop_codes(timed))
    return launches


def phase_parametric_card_vs_cpu():
    """The parametric path at float64, 64 lanes, card against CPU trip by
    trip from the same state, theta included (``lockstep``); no lane may
    part (``PARAMETRIC_MAY_PART``)."""
    from morbit_tpu_torch import AlgorithmConfig
    from morbit_tpu_torch.core.parametric import flatten, parametric_mop
    from morbit_tpu_torch.problems.synthetic import build_shifted, halton_starts

    B = 64
    theta = (torch.as_tensor(parametric_thetas(B, 2)),)
    make = lambda: parametric_mop(build_shifted, theta, flatten(theta[0])[1], True)
    ac = AlgorithmConfig(max_iter=FAMILY_LOCKSTEP_ITERS, qp_iters=QP_ITERS)
    trips, seconds, diffs, parted, _ = lockstep(
        make, halton_starts(B, LB, UB), ac, may_part=set(PARAMETRIC_MAY_PART),
        eligible=lambda st: np.ones(st.x.shape[0], bool), describe=family_part_cause,
        theta=theta)
    for pair, cause in parted.items():
        check(PARAMETRIC_MAY_PART.get(pair) == cause,
              f"parametric lane {pair[1]} parted at trip {pair[0]} ({cause})")
    phase("parametric_card_vs_cpu", B=B, dtype="float64", max_iter=FAMILY_LOCKSTEP_ITERS,
          lockstep_trips=trips, lockstep_s=seconds,
          lockstep_rho_max_rel_diff=diffs["rho"], lockstep_fit_max_rel_diff=diffs["fit"],
          parted={f"{t},{i}": c for (t, i), c in parted.items()})


def phase_mesh_main_path():
    """The main path at float32, B=1024, the reference budget, sharded over
    MESH against the unsharded run: integers, x and fx equal to the bit on
    every lane. Then the probe-tuned ``StagedMultistart`` over MESH (its
    widths compacting each shard's lanes) against the plain run in
    integers, and ``dryrun_multichip(1)``. Counts set to 0 just before the
    sharded run and read just after."""
    from morbit_tpu_torch import AlgorithmConfig, StagedMultistart, multistart_optimize
    from morbit_tpu_torch.entry import dryrun_multichip
    from morbit_tpu_torch.problems.synthetic import halton_starts

    ac = AlgorithmConfig(max_iter=100, qp_iters=QP_ITERS)
    x0 = torch.as_tensor(halton_starts(B_MAIN, LB, UB, 1 + 2 * B_MAIN), dtype=torch.float32,
                         device="cuda")
    secs = {}
    with kernels_only():
        t0 = time.perf_counter()
        plain = multistart_optimize(rbf_mop(), x0, ac, dtype=torch.float32)
        torch.cuda.synchronize()
        secs["plain"] = time.perf_counter() - t0
        _zero_launch_counts()
        t0 = time.perf_counter()
        sharded = multistart_optimize(rbf_mop(), x0, ac, dtype=torch.float32, mesh=MESH)
        torch.cuda.synchronize()
        secs["mesh"] = time.perf_counter() - t0
        launches = _launch_counts()
        tuned = StagedMultistart(rbf_mop(), ac, torch.float32).tuned(plain.n_iterations)
        runner = StagedMultistart(rbf_mop(), ac, torch.float32,
                                  schedule=tuple(t for t, _ in tuned.schedule),
                                  widths=tuned.widths, mesh=MESH)
        t0 = time.perf_counter()
        staged = runner(x0)
        torch.cuda.synchronize()
        secs["staged_mesh"] = time.perf_counter() - t0
    for name, count in launches.items():
        check(count >= sharded.trips, f"{name} launched {count} times in {sharded.trips} trips")
    _check_result(sharded, B_MAIN)
    ints = ("stop_code", "n_iterations", "n_evals")
    apart = torch.zeros(B_MAIN, dtype=torch.bool, device="cuda")
    for k in ints:
        apart |= getattr(sharded, k) != getattr(plain, k)
    for k in ("x", "fx"):
        apart |= (getattr(sharded, k) != getattr(plain, k)).any(-1)
    check(not bool(apart.any()), f"mesh lanes {lane_list(apart.cpu())} differ from "
          "the unsharded run")
    staged_apart = torch.zeros_like(apart)
    for k in ints:
        staged_apart |= getattr(staged, k) != getattr(plain, k)
    check(not bool(staged_apart.any()), f"staged mesh lanes "
          f"{lane_list(staged_apart.cpu())} differ from the plain run in integers")
    t0 = time.perf_counter()
    dry = dryrun_multichip(1)
    secs["dryrun_multichip_1"] = time.perf_counter() - t0
    phase("mesh_main_path", B=B_MAIN, dtype="float32", max_iter=100, qp_iters=QP_ITERS,
          mesh=list(MESH), launches=launches, trips=sharded.trips, plain_trips=plain.trips,
          lanes_differing=0, staged_schedule=[t for t, _ in runner.schedule],
          staged_widths=list(runner.widths),
          staged_shard_widths=list(next(iter(runner._shard_runners.values())).widths),
          staged_trips=staged.trips, staged_stage_trips=list(staged.stage_trips),
          staged_lanes_differing_in_integers=0, dryrun_multichip=dry, seconds=secs)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    rbf_launches, captured = phase_rbf_main_path()
    staged_launches, staged_captured = phase_staged_main_path()
    con_launches, con_captured = phase_constrained_main_path()
    family_launches = {kind: phase_family_main_path(kind)[0] for kind in FAMILY_KINDS}
    option_runs = {kind: phase_family_main_path(kind) for kind in OPTION_KINDS}
    option_launches = {kind: v[0] for kind, v in option_runs.items()}
    option_captured = {kind: v[1] for kind, v in option_runs.items()}
    compacted_launches = phase_compacted_main_path()
    grid_launches = phase_grid_main_path()
    parametric_launches = phase_parametric_main_path()
    mesh_launches = phase_mesh_main_path()
    wide_launches, wide_captured = phase_wide_main_path(B_WIDE, budget=WIDE_SMOKE_BUDGET)
    wide50_launches, wide50 = phase_wide_main_path(
        B_WIDE, N_WIDE50, WIDE50_BUDGET, WIDE50_SUSTAINED, WIDE50_CAPTURE_CALLS,
        "wide50_main_path")
    *admm_rows, con_rows, admm_opt, admm50 = phase_kernel_admm(
        wide_captured["qp_admm"], con_captured, option_captured, wide50["qp_admm"])
    exit_row = phase_kernel_admm_exit(option_captured["exit_eps"]["qp_admm_exit"])
    *sel_rows, sel_opt, sel50 = phase_kernel_selection(
        captured["selection"], wide_captured["selection"], staged_captured["selection"],
        option_captured, wide50["selection"])
    *r4_rows, r4_opt, r450 = phase_kernel_round4(
        captured["round4"], wide_captured["round4"], staged_captured["round4"],
        option_captured, wide50["round4"])
    gram_row, gram50 = phase_kernel_gram(wide_captured["gram"], wide50["gram"])
    del wide50
    k5_rows = phase_kernel_admm_iterations()
    lu_rows = phase_kernel_lane_lu()
    matmul_row = phase_kernel_lane_matmul()
    routing = phase_routing()
    lane_launches = phase_width_invariance_f64()
    # the float64 card runs take K6 and K7 for every library solve and
    # product whose bits depend on the batch width (kernels_only raises else)
    with kernels_only():
        phase_wide_quality_f64()
        phase_wide_card_vs_cpu()
        phase_wide50_card_vs_cpu()
        phase_rbf_card_vs_cpu()
        phase_constrained_card_vs_cpu()
        for kind in FAMILY_KINDS + OPTION_KINDS:
            phase_family_card_vs_cpu(kind)
        phase_optimize_surface()
        phase_staged_card_exact()
        phase_staged_quality_f64()
        phase_compacted_card_exact()
        phase_grid_card_vs_cpu()
        phase_parametric_card_vs_cpu()
        phase_card_vs_cpu()
    phase_main_path()

    phase("total", seconds=time.perf_counter() - started)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # per kernel: its row on the wide path, and for K1-K3 also on the RBF
    # main path, the launches of the staged main path at each budget and the
    # routing cases (B=1, f64 B=64); K5 has no caller
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
    rows50 = {"qp_admm": admm50, "rbf_selection": sel50, "rbf_round4": r450,
              "rbf_gram": gram50}
    table = []
    for name, (main_row, row), source, replaces in rows:
        check(row is not None and math.isfinite(row["ms"]), f"no row for {name}")
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "path": "wide_main_path" if name in wide_launches else None,
                 "launches": wide_launches.get(name, 0),
                 **{k: row[k] for k in keys}, "library_ms": None}
        if name in rows50:                 # K1-K4 on the n=50 path
            check(rows50[name] is not None, f"no n=50 row for {name}")
            entry["wide50_main_path"] = {"launches": wide50_launches[name],
                                         **{k: rows50[name][k] for k in keys},
                                         "library_ms": None}
        if main_row is not None:
            entry["rbf_main_path"] = {"launches": rbf_launches[name],
                                      **{k: main_row[k] for k in keys}}
            entry["staged_main_path"] = {
                f"max_iter_{b['max_iter']}": {"launches": counts[name]}
                for b, counts in zip(STAGED_BUDGETS, staged_launches)}
            entry["routing"] = routing[name]
            entry["constrained_main_path"] = {
                f"max_iter_{b['max_iter']}": {"launches": counts[name]}
                for b, counts in zip(STAGED_BUDGETS, con_launches)}
        if main_row is not None:           # the Taylor, Lagrange, PS paths
            for kind in FAMILY_KINDS:
                entry[f"{kind}_main_path"] = {"launches": family_launches[kind][name]}
            # the composite, 'model'-scaler and no-database paths, with the
            # rows of the inputs they recorded
            recorded_rows = {"qp_admm": admm_opt, "rbf_selection": sel_opt,
                             "rbf_round4": r4_opt}[name]
            for kind in OPTION_KINDS:
                entry[f"{kind}_main_path"] = {"launches": option_launches[kind][name]}
                rec = recorded_rows.get(kind)
                if name == "qp_admm":
                    for shape, row_o in (rec or {}).items():
                        entry[f"{kind}_main_path"][shape] = {k: row_o[k] for k in keys}
                elif rec is not None:
                    entry[f"{kind}_main_path"]["recorded"] = {
                        k: rec[k] for k in keys + ("B", "n")}
        # the compacted runner's first batch at each budget (K1-K3) and the
        # benchmark grid (K1-K4; K4 at n=15)
        if main_row is not None:
            entry["compacted_main_path"] = {
                f"max_iter_{b['max_iter']}": {"launches": counts[name]}
                for b, counts in zip(STAGED_BUDGETS, compacted_launches)}
            # the parametric runner's warm-up batch and the sharded main path
            entry["parametric_main_path"] = {"launches": parametric_launches[name]}
            entry["mesh_main_path"] = {"launches": mesh_launches[name]}
        entry["grid_main_path"] = {"launches": grid_launches.get(name, 0)}
        if name == "qp_admm":              # K1 at the constrained LP shapes
            entry["exit_eps_main_path"]["exit_instance_nv3_m6"] = {
                k: exit_row[k] for k in keys + ("fixed_trip_ms", "stages_per_lane_hist", "B")}
            for b, counts in zip(STAGED_BUDGETS, con_launches):
                entry["constrained_main_path"][f"max_iter_{b['max_iter']}"][
                    "launches_by_shape"] = counts["qp_admm_by_shape"]
            for shape, row_c in con_rows.items():
                entry["constrained_main_path"][shape] = {k: row_c[k] for k in keys}
        if name == "admm_iterations":      # K5's (21, 42) row above; also (3, 6)
            entry["shape"] = [row["n"], row["m"]]
            entry["n3_m6"] = {k: k5_rows[0][k] for k in keys}
        table.append(entry)
    # K6 and K7 replace no Pallas kernel but the library calls named: their
    # path is the float64 one of ``width_invariance_f64``, their row the
    # main path's fit there (LANE_TABLE_SHAPE), library_ms the library call
    lane_rows = (("lane_lu_factor", lu_rows["factor"], "morbit_tpu_torch/csrc/lane_lu.cu",
                  "none (a library call): torch.linalg.solve_ex and lu_factor_ex on float64 "
                  "CUDA tensors, morbit_tpu_torch/ops/batched_linalg.py solve_small and "
                  "morbit_tpu_torch/ops/qp.py _polish (JAX: morbit_tpu/ops/batched_linalg.py:147, "
                  "morbit_tpu/ops/qp.py:328)"),
                 ("lane_lu_solve", lu_rows["solve"], "morbit_tpu_torch/csrc/lane_lu.cu",
                  "none (a library call): torch.linalg.solve_ex and lu_solve on float64 CUDA "
                  "tensors (JAX: morbit_tpu/ops/batched_linalg.py:147, "
                  "morbit_tpu/ops/qp.py:329)"),
                 ("lane_matmul", matmul_row, "morbit_tpu_torch/csrc/lane_matmul.cu",
                  "none (a library call): a @ b and einsum on float64 CUDA tensors, "
                  "morbit_tpu_torch/ops/batched_linalg.py lane_matmul and lane_product"))
    for name, row, source, replaces in lane_rows:
        check(row is not None and math.isfinite(row["ms"]), f"no row for {name}")
        table.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "path": "width_invariance_f64", "launches": lane_launches[name],
                      **{k: row[k] for k in keys}, "library_ms": row["library_ms"],
                      "shape_k_m_B": list(LANE_TABLE_SHAPE)})
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
