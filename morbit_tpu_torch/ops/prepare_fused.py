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
#: no multiply-add contraction: the kernels then round every operation as
#: their twins do, so decisions at exact ties (a score equal to its pivot,
#: the two box exits of a direction) fall the same way on both
NO_FMA = ("--fmad=false",)

#: largest sizes the kernels take: K2's register arrays (n = 2, 3) and
#: block instance; K3's thread-per-lane instance, and its block-per-lane
#: instance whose state lives in a workspace (the wide-n path: max_points =
#: 231 at n = 20)
SELECTION_MAX_N = 32
#: K2's register instances; every other n takes the block instance
SELECTION_REGISTER_N = (2, 3)
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

_SELECTION_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] + [ctypes.c_double] * 4
                       + [ctypes.c_int, ctypes.c_void_p])
_ROUND4_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
                    + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                    + [ctypes.c_double] * 3 + [ctypes.c_void_p])
# the block-per-lane instance takes its two workspaces after N_out
_ROUND4_WIDE_ARGTYPES = (_ROUND4_ARGTYPES[:10] + [ctypes.c_void_p] * 2
                         + _ROUND4_ARGTYPES[10:])
_SIGNATURES = {
    SELECTION_SOURCE: {f"rbf_selection_{t}": _SELECTION_ARGTYPES for t in ("f32", "f64")},
    ROUND4_SOURCE: {**{f"rbf_round4_{t}": _ROUND4_ARGTYPES for t in ("f32", "f64")},
                    **{f"rbf_round4_wide_{t}": _ROUND4_WIDE_ARGTYPES
                       for t in ("f32", "f64")},
                    "rbf_round4_wide_lane_elems": ([ctypes.c_int] * 3, ctypes.c_longlong)},
}


def build_selection():
    return cuda_build.build(SELECTION_SOURCE, NO_FMA)


def build_round4():
    return cuda_build.build(ROUND4_SOURCE, NO_FMA)


def _library(source):
    if source not in _libs:
        _libs[source] = cuda_build.load(source, _SIGNATURES[source], NO_FMA)
    return _libs[source]


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
    """Candidate rows whose offsets the block instance stages in shared
    memory (0 for the register instances)."""
    if n in SELECTION_REGISTER_N:
        return 0
    return SELECTION_STAGE_BYTES // (_selection_ld(n, itemsize) * itemsize)


def selection_smem_bytes(n: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of K2 at n (``block_layout`` in
    the source): 0 for the register instances; else the complement by rows
    and by columns, the staged rows, the directions, seven vectors, Q and
    the reflections (rows padded to an odd stride), the reduction slots, and
    the ints (two pick lists, the reflection flags, the reduction and
    compaction slots)."""
    if n in SELECTION_REGISTER_N:
        return 0
    ld = _selection_ld(n, itemsize)
    w = SELECTION_BLOCK_WARPS
    elems = ((3 * n + selection_stage_rows(n, itemsize) + 7) * ld
             + 2 * n * (n | 1) + w)
    return elems * itemsize + (3 * SELECTION_MAX_N + 2 * w) * 4


def selection_cuda(X, count, x_s, x_index, delta, lb_s, ub_s, max_new, efl, *,
                   theta_e1, theta_e2_dmax, theta_pivot, delta_max,
                   skip2_same_theta):
    """Launch the ``rbf_selection`` kernel on the current stream; arguments
    and outputs as :func:`rbf_selection_core`. The block instance's
    candidate lists live in a (B, cap) workspace allocated here."""
    global selection_launches
    B, cap, n = X.shape
    dt = cuda_build.float_dtype("rbf_selection", X)
    item = X.element_size()
    smem = selection_smem_bytes(n, item)
    if n > SELECTION_MAX_N or smem > cuda_build.SMEM_LIMIT:
        raise NotImplementedError(
            f"rbf_selection kernel takes n <= {SELECTION_MAX_N} within "
            f"{cuda_build.SMEM_LIMIT} bytes of shared memory, got X of shape "
            f"{tuple(X.shape)}")
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
    block = n not in SELECTION_REGISTER_N
    work = new((B * cap if block else 0,), i32)
    lib = _library(SELECTION_SOURCE)
    fn = lib.rbf_selection_f32 if dt == torch.float32 else lib.rbf_selection_f64
    p = cuda_build.ptr
    err = fn(p(X), lane_stride, row_stride, p(count), p(x_s), p(x_index),
             p(delta), p(lb_s), p(ub_s), p(max_new), p(efl), *map(p, outs),
             p(work) if block else None, B, cap, n, selection_stage_rows(n, item),
             smem, theta_e1, theta_e2_dmax, theta_pivot, delta_max,
             int(bool(skip2_same_theta)), cuda_build.stream_of(X))
    if err != 0:
        raise RuntimeError(f"rbf_selection kernel launch failed: cudaError_t {err}")
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
    """Dynamic shared memory of one block of K3's block-per-lane instance
    (``wide_smem_elems`` in the source): eight vectors of ``max_points``,
    two pd x pd buffers for R's leading rows and five vectors of pd."""
    return itemsize * (8 * max_points + 2 * pd * pd + 5 * pd)


def round4_cuda(X, cand, init_sites, n_init, *, kernel, param, poly_deg,
                max_points, chol_pivot):
    """Launch the ``rbf_round4`` kernel on the current stream; arguments and
    outputs as :func:`run_round4`, whose state buffers the kernel sizes to
    ``max_points`` (rows past the count are padding in both). The
    thread-per-lane instance takes ``max_points <= 24``; the block-per-lane
    instance, whose state the wrapper allocates, takes the rest up to
    ``ROUND4_WIDE_MAX_POINTS``."""
    global round4_launches
    B, C, n = X.shape
    pd = poly_dim(n, poly_deg)
    narrow = (max_points <= ROUND4_MAX_POINTS and pd <= ROUND4_MAX_PD
              and n <= ROUND4_MAX_N)
    dt = cuda_build.float_dtype("rbf_round4", X)
    if not narrow and (max_points > ROUND4_WIDE_MAX_POINTS or n > ROUND4_WIDE_MAX_N
                       or pd > max_points
                       or round4_wide_smem_bytes(max_points, pd, X.element_size())
                       > cuda_build.SMEM_LIMIT):
        raise NotImplementedError(
            f"rbf_round4 kernel takes max_points <= {ROUND4_WIDE_MAX_POINTS}, "
            f"n <= {ROUND4_WIDE_MAX_N} and pd <= max_points within "
            f"{cuda_build.SMEM_LIMIT} bytes of shared memory, got "
            f"max_points={max_points}, n={n}, pd={pd}")
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
    lib = _library(ROUND4_SOURCE)
    t = "f32" if dt == torch.float32 else "f64"
    p = cuda_build.ptr
    head = (p(X), lane_stride, row_stride, p(cand), p(init_sites),
            init_sites.stride(0), p(n_init), p(param_t), p(accepted), p(N))
    tail = (B, C, n, max_points, pd, KERNEL_ID[kernel], exponent, coef, pivot2,
            cuda_build.stream_of(X))
    if narrow:
        err = getattr(lib, f"rbf_round4_{t}")(*head, *tail)
    else:
        lane = lib.rbf_round4_wide_lane_elems(max_points, n, pd)
        work = torch.empty((B * lane,), dtype=dt, device=X.device)
        cand_list = torch.empty((B * C,), dtype=torch.int32, device=X.device)
        err = getattr(lib, f"rbf_round4_wide_{t}")(*head, p(work), p(cand_list), *tail)
    if err != 0:
        raise RuntimeError(f"rbf_round4 kernel launch failed: cudaError_t {err}")
    round4_launches += 1
    return accepted, N


def round4(X, cand, init_sites, n_init, **kw):
    """Round-4 acceptance for a batch of lanes. CPU tensors take the plain
    twin, CUDA tensors launch K3 or raise."""
    if X.device.type == "cpu":
        return run_round4(X, cand, init_sites, n_init, **kw)
    return round4_cuda(X, cand, init_sites, n_init, **kw)
