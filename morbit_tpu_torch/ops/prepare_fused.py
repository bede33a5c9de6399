"""Routing of the RBF selection kernels K2 (rounds 1-3) and K3 (round 4).

Counterpart of ``morbit_tpu/ops/prepare_fused.py``, which routes the same
two computations to its Pallas kernels. Here:

* :func:`selection` runs rounds 1-3 for a batch of lanes: CPU tensors take
  the plain twin :func:`morbit_tpu_torch.ops.prepare_coord.rbf_selection_core`,
  CUDA tensors launch the kernel in ``csrc/rbf_selection.cu``;
* :func:`round4` runs the round-4 acceptance: CPU tensors take
  :func:`morbit_tpu_torch.models.rbf_round4.run_round4`, CUDA tensors launch
  the kernel in ``csrc/rbf_round4.cu``.

There is no fallback between the two: a CUDA tensor launches the kernel or
raises, whatever the batch size or dtype. Each kernel is built with ``nvcc``
at first use (:mod:`morbit_tpu_torch.ops.cuda_build`) and counts its
launches in a plain integer.
"""

from __future__ import annotations

import ctypes

import torch

from morbit_tpu_torch.models.rbf_round4 import run_round4
from morbit_tpu_torch.ops import cuda_build
from morbit_tpu_torch.ops.prepare_coord import rbf_selection_core
from morbit_tpu_torch.ops.rbf import KERNEL_ID, phi_constants, poly_dim

SELECTION_SOURCE = cuda_build.CSRC / "rbf_selection.cu"
ROUND4_SOURCE = cuda_build.CSRC / "rbf_round4.cu"
#: K3's float64 build: its cubic phi calls the power linked from
#: ``rbf_pow.cu``, built with the default multiply-add contraction so that
#: it rounds as PyTorch's CUDA pow (the twin's ``r2 ** 1.5``) does; the
#: float32 build keeps its inline pow (it agrees either way) and stays one
#: translation unit
ROUND4_F64_FLAGS = ("-DMORBIT_LINKED_POW",)
ROUND4_LINKED = (cuda_build.CSRC / "rbf_pow.cu",)

#: the instances' ranges: K2's register instances (n = 2, 3), its block
#: instance (n <= 32) and its wide instance (every other n); K3's
#: thread-per-lane instance, its block-per-lane instance whose state lives
#: in a workspace (the 20-variable path: max_points = 231 at n = 20), and
#: its slot instance (every other shape: the same design, a workspace slot
#: a resident block, the lanes looped over the slots)
SELECTION_BLOCK_MAX_N = 32
#: K2's register instances
SELECTION_REGISTER_N = (2, 3)
#: K2's block and wide instances' threads a block (``kBlockThreads``)
SELECTION_BLOCK_THREADS = 128
#: shared memory for the staged candidate offsets of K2's block instance
SELECTION_STAGE_BYTES = 24 * 1024
#: warps of a block of K2's block instance (``kBlockThreads`` / 32)
SELECTION_BLOCK_WARPS = 4
ROUND4_MAX_POINTS, ROUND4_MAX_PD, ROUND4_MAX_N = 24, 16, 15
ROUND4_WIDE_MAX_POINTS, ROUND4_WIDE_MAX_N = 512, 32

#: kernel launches since the counters were last set to 0 (each wrapper adds
#: one per launch; callers reset them to prove a run went through a kernel)
selection_launches = 0
round4_launches = 0

_libs = {}
#: blocks of K3's slot instance resident on a card at once, by (device,
#: dtype, shared bytes): the grid of a slot launch
_round4_resident = {}

_SELECTION_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] * 19 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_double] * 4
                       + [ctypes.c_int, ctypes.c_void_p])
_SELECTION_INSTANCES = {"register": 0, "block": 1, "wide": 2}
_ROUND4_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
                    + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                    + [ctypes.c_double] * 3 + [ctypes.c_void_p])
# the block-per-lane instance takes its two workspaces after N_out
_ROUND4_WIDE_ARGTYPES = (_ROUND4_ARGTYPES[:10] + [ctypes.c_void_p] * 2
                         + _ROUND4_ARGTYPES[10:])
# the slot instance takes its place and slot count before the stream
_ROUND4_SLOTS_ARGTYPES = (_ROUND4_WIDE_ARGTYPES[:-1] + [ctypes.c_int] * 2
                          + _ROUND4_WIDE_ARGTYPES[-1:])
_SIGNATURES = {
    SELECTION_SOURCE: {f"rbf_selection_{t}": _SELECTION_ARGTYPES for t in ("f32", "f64")},
    ROUND4_SOURCE: {**{f"rbf_round4_{t}": _ROUND4_ARGTYPES for t in ("f32", "f64")},
                    **{f"rbf_round4_wide_{t}": _ROUND4_WIDE_ARGTYPES
                       for t in ("f32", "f64")},
                    **{f"rbf_round4_slots_{t}": _ROUND4_SLOTS_ARGTYPES
                       for t in ("f32", "f64")},
                    **{f"rbf_round4_slots_resident_{t}": ([ctypes.c_int] * 3, ctypes.c_int)
                       for t in ("f32", "f64")},
                    "rbf_round4_slot_lane_elems": ([ctypes.c_int] * 4, ctypes.c_longlong)},
}


def build_selection():
    return cuda_build.build(SELECTION_SOURCE, cuda_build.NO_FMA)


def build_round4(dtype=torch.float32):
    if dtype == torch.float64:
        return cuda_build.build(ROUND4_SOURCE, cuda_build.NO_FMA + ROUND4_F64_FLAGS, ROUND4_LINKED)
    return cuda_build.build(ROUND4_SOURCE, cuda_build.NO_FMA)


def _library(source, dtype=torch.float32):
    """The loaded library of ``source``; K3's float64 calls take its
    float64 build (:func:`build_round4`), cached under (source, dtype)."""
    f64 = source == ROUND4_SOURCE and dtype == torch.float64
    key = (source, dtype) if f64 else source
    if key not in _libs:
        _libs[key] = cuda_build.load(source, _SIGNATURES[source],
                                     cuda_build.NO_FMA + (ROUND4_F64_FLAGS if f64 else ()),
                                     ROUND4_LINKED if f64 else ())
    return _libs[key]


def _site_view(kernel, X, B, C, n, dtype):
    """Check a (B, C, n) site view (a strided slice of the database is
    accepted: only its last axis must be dense) and return its strides."""
    if tuple(X.shape) != (B, C, n):
        raise ValueError(f"{kernel}: X has shape {tuple(X.shape)}, expected {(B, C, n)}")
    if X.device.type != "cuda":
        raise ValueError(f"{kernel}: X is on {X.device}, expected a cuda device")
    if X.dtype != dtype:
        raise TypeError(f"{kernel}: X is {X.dtype}, expected {dtype}")
    if X.stride(-1) != 1:
        raise ValueError(f"{kernel}: the coordinates of X must be contiguous")
    return X.stride(0), X.stride(1)


# --------------------------------------------------------------- K2: rounds 1-3

def _selection_ld(n: int, itemsize: int) -> int:
    """Row stride of the block instance's vector-read arrays: n rounded up
    to a 16-byte multiple."""
    vec = 16 // itemsize
    return -(-n // vec) * vec


def selection_stage_rows(n: int, itemsize: int) -> int:
    """Candidate rows whose offsets the block and wide instances stage in
    shared memory where it holds them (0 for the register instances)."""
    if n in SELECTION_REGISTER_N:
        return 0
    return SELECTION_STAGE_BYTES // (_selection_ld(n, itemsize) * itemsize)


def _selection_wide_sizes(n: int, itemsize: int, place: int,
                          stage_rows: int) -> tuple[int, int]:
    """Shared bytes of a block of K2's wide instance and a lane's workspace
    elements (``wide_sel_layout`` in the source): the staged rows, eight
    vectors and the reduction slots, and the ints (two pick lists and the
    reflection flags of n, the reduction and compaction slots); the
    complement by rows and by columns and the directions (rows of n rounded
    up to 16 bytes), Q and the reflections (rows padded to an odd stride)
    and a column of n per thread for proj, in shared memory at place 0,
    else in the workspace, with the rest after them at place 2."""
    vec = 16 // itemsize
    ld = _selection_ld(n, itemsize)
    w = SELECTION_BLOCK_WARPS
    mat = 3 * n * ld + 2 * n * (n | 1) + n * SELECTION_BLOCK_THREADS
    mat = -(-mat // vec) * vec
    elems = (stage_rows + 8) * ld + -(-w // vec) * vec
    if place == 0:
        elems += mat
    nbytes = elems * itemsize + (3 * n + 2 * w) * 4
    if place == 0:
        return nbytes, 0
    if place == 1:
        return nbytes, mat
    return 0, mat + -(-nbytes // itemsize)


def selection_plan(n: int, itemsize: int) -> cuda_build.Plan:
    """The launch of K2 at n: the register instances at n = 2, 3 (one
    thread a lane, 128 lanes a block); up to ``SELECTION_BLOCK_MAX_N`` the
    block instance (one 128-thread block a lane: the complement by rows and
    by columns, the staged rows, the directions, seven vectors, Q and the
    reflections (rows padded to an odd stride), the reduction slots, and the
    ints: two pick lists, the reflection flags, the reduction and compaction
    slots, ``block_layout`` in the source); elsewhere the wide instance with
    its matrices in shared memory where they fit (place 0), else in a
    workspace (place 1, as many staged rows as fit), else with everything
    in the workspace (place 2). The block and wide instances also take a
    (B, cap) int workspace for the candidate lists."""
    limit = cuda_build.SMEM_LIMIT
    if n in SELECTION_REGISTER_N:
        return cuda_build.Plan("register", 128, 0)
    ld = _selection_ld(n, itemsize)
    rows = selection_stage_rows(n, itemsize)
    if n <= SELECTION_BLOCK_MAX_N:
        w = SELECTION_BLOCK_WARPS
        elems = (3 * n + rows + 7) * ld + 2 * n * (n | 1) + w
        smem = elems * itemsize + (3 * SELECTION_BLOCK_MAX_N + 2 * w) * 4
        if smem <= limit:
            return cuda_build.Plan("block", 1, smem, stage_rows=rows)
    smem, _ = _selection_wide_sizes(n, itemsize, 0, rows)
    if smem <= limit:
        return cuda_build.Plan("wide", 1, smem, stage_rows=rows)
    smem, mat = _selection_wide_sizes(n, itemsize, 1, 0)
    if smem <= limit:
        rows = min(rows, (limit - smem) // (ld * itemsize))
        smem, mat = _selection_wide_sizes(n, itemsize, 1, rows)
        return cuda_build.Plan("wide", 1, smem, mat, 1, rows)
    return cuda_build.Plan("wide", 1, *_selection_wide_sizes(n, itemsize, 2, 0), 2)


def selection_cuda(X, count, x_s, x_index, delta, lb_s, ub_s, max_new, efl, *,
                   theta_e1, theta_e2_dmax, theta_pivot, delta_max,
                   skip2_same_theta):
    """Launch the ``rbf_selection`` kernel on the current stream as
    :func:`selection_plan` plans it; arguments and outputs as
    :func:`rbf_selection_core`. The candidate lists of the block and wide
    instances live in a (B, cap) workspace allocated here, and so do the
    wide instance's matrices where the plan puts them in a workspace."""
    global selection_launches
    B, cap, n = X.shape
    dt = cuda_build.float_dtype("rbf_selection", X)
    item = X.element_size()
    plan = selection_plan(n, item)
    lane_stride, row_stride = _site_view("rbf_selection", X, B, cap, n, dt)
    i32 = torch.int32
    cuda_build.check_args("rbf_selection", X.device, {
        "count": (count, (B,), i32), "x_s": (x_s, (B, n), dt),
        "x_index": (x_index, (B,), i32), "delta": (delta, (B,), dt),
        "lb_s": (lb_s, (B, n), dt), "ub_s": (ub_s, (B, n), dt),
        "max_new": (max_new, (B,), i32), "efl": (efl, (B,), torch.bool)})
    new = lambda shape, t: torch.empty(shape, dtype=t, device=X.device)
    outs = (new((B, n), i32), new((B,), i32), new((B, n), i32), new((B,), i32),
            new((B, n, n), dt), new((B, n), torch.bool), new((B,), i32),
            new((B, n, n), dt), new((B,), i32), new((B,), torch.bool))
    block = plan.instance != "register"
    work = new((B * cap if block else 0,), i32)
    mat = new((B * plan.work_elems,), dt)
    lib = _library(SELECTION_SOURCE)
    fn = lib.rbf_selection_f32 if dt == torch.float32 else lib.rbf_selection_f64
    p = cuda_build.ptr
    cuda_build.launch("rbf_selection", lambda: fn(
        p(X), lane_stride, row_stride, p(count), p(x_s), p(x_index),
        p(delta), p(lb_s), p(ub_s), p(max_new), p(efl), *map(p, outs),
        p(work) if block else None, B, cap, n, plan.stage_rows,
        _SELECTION_INSTANCES[plan.instance], plan.place,
        p(mat) if plan.work_elems else None, plan.smem_bytes, theta_e1,
        theta_e2_dmax, theta_pivot, delta_max, int(bool(skip2_same_theta)),
        cuda_build.stream_of(X)))
    selection_launches += 1
    return outs


def selection(X, count, x_s, x_index, delta, lb_s, ub_s, max_new, efl, **statics):
    """Rounds 1-3 for a batch of lanes. CPU tensors take the plain twin,
    CUDA tensors launch K2 or raise."""
    if X.device.type == "cpu":
        return rbf_selection_core(X, count, x_s, x_index, delta, lb_s, ub_s,
                                  max_new, efl, **statics)
    return selection_cuda(X, count, x_s, x_index, delta, lb_s, ub_s, max_new,
                          efl, **statics)


# ----------------------------------------------------------------- K3: round 4

def round4_wide_smem_bytes(max_points: int, pd: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of K3's block-per-lane and slot
    instances (``wide_smem_elems`` in the source): eight vectors of
    ``max_points``, two pd x pd buffers for R's leading rows and five
    vectors of pd."""
    return itemsize * (8 * max_points + 2 * pd * pd + 5 * pd)


def _round4_lane_elems(ld: int, n: int, pd: int) -> int:
    """A lane's state in K3's workspace at row stride ``ld``
    (``wide_lane_elems`` in the source)."""
    return ld * (n + 2 * pd) + 5 * ld * ld


def round4_plan(max_points: int, n: int, pd: int, itemsize: int) -> cuda_build.Plan:
    """The launch of K3: the thread-per-lane instance at ``max_points <=
    24`` (128 lanes a block); up to ``ROUND4_WIDE_MAX_POINTS`` and
    ``ROUND4_WIDE_MAX_N`` (pd <= max_points) the block-per-lane instance, a
    lane's state in a workspace of B lanes; every other shape the slot
    instance, the same design with a workspace slot for each resident
    block the card keeps resident, the state's rows max(max_points, pd)
    long, and its shared vectors in the slot too where they pass a block's
    shared memory (place 1). ``work_elems`` is a lane's or a slot's
    state."""
    if max_points <= ROUND4_MAX_POINTS and pd <= ROUND4_MAX_PD and n <= ROUND4_MAX_N:
        return cuda_build.Plan("thread", 128, 0)
    smem = round4_wide_smem_bytes(max_points, pd, itemsize)
    if (max_points <= ROUND4_WIDE_MAX_POINTS and n <= ROUND4_WIDE_MAX_N
            and pd <= max_points and smem <= cuda_build.SMEM_LIMIT):
        return cuda_build.Plan("block", 1, smem, _round4_lane_elems(max_points, n, pd))
    core = _round4_lane_elems(max(max_points, pd), n, pd)
    if smem <= cuda_build.SMEM_LIMIT:
        return cuda_build.Plan("slots", 1, smem, core)
    return cuda_build.Plan("slots", 1, 0, core + smem // itemsize, 1)


def _resident(lib, t, plan, max_points, pd, device):
    """Blocks of K3's slot instance at this plan's shared memory that the
    card keeps resident (its SMs times the instance's occupancy), asked of
    the CUDA runtime once per device, dtype and shape: the slot launch's
    grid (more blocks would wait for a free SM, each with a slot of its
    own)."""
    key = (device, t, plan.smem_bytes, plan.place)
    if key not in _round4_resident:
        with torch.cuda.device(device):
            got = getattr(lib, f"rbf_round4_slots_resident_{t}")(max_points, pd, plan.place)
        if got <= 0:
            raise RuntimeError(f"rbf_round4 occupancy query failed: cudaError_t {-got}")
        _round4_resident[key] = got
    return _round4_resident[key]


def round4_cuda(X, cand, init_sites, n_init, *, kernel, param, poly_deg,
                max_points, chol_pivot, slots=None):
    """Launch the ``rbf_round4`` kernel on the current stream as
    :func:`round4_plan` plans it; arguments and outputs as
    :func:`run_round4`, whose state buffers the kernel sizes to
    ``max_points`` (rows past the count are padding in both). The wrapper
    allocates the block and slot instances' state and candidate lists.
    ``slots`` sets the slot instance's grid (default the card's resident
    blocks, at most B), so that a test can loop a few lanes over fewer
    slots."""
    global round4_launches
    B, C, n = X.shape
    pd = poly_dim(n, poly_deg)
    dt = cuda_build.float_dtype("rbf_round4", X)
    plan = round4_plan(max_points, n, pd, X.element_size())
    lane_stride, row_stride = _site_view("rbf_round4", X, B, C, n, dt)
    static = isinstance(param, (int, float))
    param_t = (torch.full((B,), float(param), dtype=dt, device=X.device)
               if static else param)
    S = init_sites.shape[1]
    cuda_build.check_args("rbf_round4", X.device, {
        "cand": (cand, (B, C), torch.bool), "init_sites": (init_sites, (B, S, n), dt),
        "n_init": (n_init, (B,), torch.int32), "param": (param_t, (B,), dt)})
    exponent, coef = phi_constants(kernel, param)
    pivot2 = float(torch.tensor(chol_pivot, dtype=dt) ** 2)
    accepted = torch.empty((B, C), dtype=torch.bool, device=X.device)
    N = torch.empty((B,), dtype=torch.int32, device=X.device)
    lib = _library(ROUND4_SOURCE, dt)
    t = "f32" if dt == torch.float32 else "f64"
    p = cuda_build.ptr
    head = (p(X), lane_stride, row_stride, p(cand), p(init_sites),
            init_sites.stride(0), p(n_init), p(param_t), p(accepted), p(N))
    tail = (B, C, n, max_points, pd, KERNEL_ID[kernel], exponent, coef, pivot2,
            cuda_build.stream_of(X))
    if plan.instance == "thread":
        cuda_build.launch("rbf_round4", lambda: getattr(lib, f"rbf_round4_{t}")(*head, *tail))
    else:
        if plan.instance == "block":
            slots = B
        elif slots is None:
            slots = min(B, _resident(lib, t, plan, max_points, pd, X.device))
        work = torch.empty((slots * plan.work_elems,), dtype=dt, device=X.device)
        cand_list = torch.empty((B * C,), dtype=torch.int32, device=X.device)
        if plan.instance == "block":
            cuda_build.launch("rbf_round4", lambda: getattr(lib, f"rbf_round4_wide_{t}")(
                *head, p(work), p(cand_list), *tail))
        else:
            cuda_build.launch("rbf_round4", lambda: getattr(lib, f"rbf_round4_slots_{t}")(
                *head, p(work), p(cand_list), *tail[:-1], plan.place, slots, tail[-1]))
    round4_launches += 1
    return accepted, N


def round4(X, cand, init_sites, n_init, **kw):
    """Round-4 acceptance for a batch of lanes. CPU tensors take the plain
    twin, CUDA tensors launch K3 or raise."""
    if X.device.type == "cpu":
        return run_round4(X, cand, init_sites, n_init, **kw)
    return round4_cuda(X, cand, init_sites, n_init, **kw)
