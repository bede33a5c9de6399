"""Lane-invariant float64 LU solves (K6) and lane products (K7) on the card.

Two hand-written CUDA kernels that replace no Pallas kernel: they replace
the card's float64 library calls whose bits depend on how many lanes share
the launch (``torch.linalg.solve_ex``, ``lu_factor_ex`` + ``lu_solve`` and
``a @ b``: cuSOLVER and cuBLAS choose their algorithm by the batch size,
ROADMAP 3.15). Here one lane's result is one fixed sequence of roundings:

* K6 ``csrc/lane_lu.cu`` — :func:`lane_lu_factor_cuda` (partial
  pivoting, right-looking, one block a lane; in panels where the lane
  lives in global memory) and :func:`lane_lu_solve_cuda`;
* K7 ``csrc/lane_matmul.cu`` — :func:`lane_matmul_cuda`, float64, one
  thread an output entry, each sum in index order.

Routing is the callers' (:mod:`morbit_tpu_torch.ops.batched_linalg`,
:mod:`morbit_tpu_torch.ops.qp`): float64 CUDA tensors launch these
kernels; CPU tensors keep the LAPACK and BLAS calls, which is what the JAX
package computes on the CPU, so the goldens and the JAX lockstep tests
stand on it; float32 calls are unchanged. The plain twins ``*_plain``
repeat each kernel's arithmetic in the same order (one column at a time,
every multiply and subtract its own operation), so on the card they equal
the kernels to the bit. No run takes them: the tests and
``chip_smoke.py``'s kernel-against-twin phases call them.

There is no fallback: a CUDA tensor launches the kernel or raises. Each
kernel is built with ``nvcc --fmad=false`` at first use
(:mod:`morbit_tpu_torch.ops.cuda_build`) and counts its launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from morbit_tpu_torch.ops import cuda_build

LU_SOURCE = cuda_build.CSRC / "lane_lu.cu"
MATMUL_SOURCE = cuda_build.CSRC / "lane_matmul.cu"
#: the reduction slots of a factor block (``kWarps``: one per warp, at most
#: 32 warps)
LU_WARPS = 32
#: the global factor's panel width and trailing tiles (``kPanel``,
#: ``kTileRows``, ``kTileCols``)
LU_PANEL, LU_TILE_ROWS, LU_TILE_COLS = 32, 64, 64

#: kernel launches since the counters were last set to 0 (each wrapper adds
#: one per launch; callers reset them to prove a run went through a kernel)
lu_factor_launches = 0
lu_solve_launches = 0
matmul_launches = 0

_LU_FACTOR_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_longlong, ctypes.c_void_p]
_LU_SOLVE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
    ctypes.c_longlong, ctypes.c_void_p]
_SIGNATURES = {
    LU_SOURCE: {**{f"lane_lu_factor_{t}": _LU_FACTOR_ARGTYPES for t in ("f32", "f64")},
                **{f"lane_lu_solve_{t}": _LU_SOLVE_ARGTYPES for t in ("f32", "f64")}},
    MATMUL_SOURCE: {"lane_matmul_f64": [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p]},
}
_libs = {}


def _library(source):
    if source not in _libs:
        _libs[source] = cuda_build.load(source, _SIGNATURES[source], cuda_build.NO_FMA)
    return _libs[source]


def build_lu():
    return cuda_build.build(LU_SOURCE, cuda_build.NO_FMA)


def build_matmul():
    return cuda_build.build(MATMUL_SOURCE, cuda_build.NO_FMA)


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "f64"


# ------------------------------------------------------------------ the plans

def lu_factor_plan(k: int, itemsize: int) -> cuda_build.Plan:
    """The launch of K6's factor at size ``k``, one block a lane: the lane's
    matrix in shared memory where it fits a block's 227 KB (``shared``,
    k <= 169 at float64), factored in place in the output otherwise, in
    panels (``global``). Shared bytes mirror ``factor_smem_bytes`` in the
    source, with 16 for alignment. Raises only on a bad argument."""
    if k < 1:
        raise ValueError(f"lane_lu_factor: k must be positive, got {k}")
    base = LU_WARPS * (itemsize + 4) + 4 * k + 16
    ld = k + 1 - k % 2                  # odd row stride (``factor_ld``)
    shared = base + itemsize * k * ld
    if shared <= cuda_build.SMEM_LIMIT:
        return cuda_build.Plan("shared", 1, shared)
    return cuda_build.Plan("global", 1, base + itemsize * LU_PANEL * (LU_TILE_ROWS + LU_TILE_COLS))


def lu_solve_plan(k: int, m: int, itemsize: int) -> cuda_build.Plan:
    """The launch of K6's solve for ``m`` right-hand sides, one block a
    lane: x in shared memory where its k m values fit, in the output
    otherwise. Raises only on a bad argument."""
    if k < 1 or m < 1:
        raise ValueError(f"lane_lu_solve: k and m must be positive, got k={k}, m={m}")
    smem = itemsize * k * m
    if smem <= cuda_build.SMEM_LIMIT:
        return cuda_build.Plan("shared", 1, smem)
    return cuda_build.Plan("global", 1, 0)


# --------------------------------------------------------- K6: the plain twins

def lane_lu_factor_plain(A: torch.Tensor):
    """LU with partial pivoting of (B, k, k) ``A``, in K6's order: for each
    column j the first row of the largest |a_ij| (``torch.argmax``'s rule),
    a whole-row swap, l = a_ij / a_jj (left as it is where a_jj == 0, all
    zeros), then a_ic - l_i * a_jc, a multiply and a subtract. Returns (LU,
    perm, info): row i of LU factors row ``perm[i]`` of A (int32); info is
    the first column with an exactly zero pivot, counted from 1, else 0.
    K6's twin; runs take LAPACK on the CPU (see the module's note)."""
    B, k = A.shape[0], A.shape[-1]
    a = A.clone()
    perm = torch.arange(k, dtype=torch.int32, device=A.device).repeat(B, 1)
    info = torch.zeros(B, dtype=torch.int32, device=A.device)
    lanes = torch.arange(B, device=A.device)
    for j in range(k):
        p = j + torch.argmax(a[:, j:, j].abs(), dim=1)
        row_j, row_p = a[lanes, j].clone(), a[lanes, p].clone()
        a[lanes, p] = row_j
        a[lanes, j] = row_p
        perm_j, perm_p = perm[lanes, j].clone(), perm[lanes, p].clone()
        perm[lanes, p] = perm_j
        perm[lanes, j] = perm_p
        d = a[:, j, j]
        zero = d == 0
        info = torch.where(zero & (info == 0), j + 1, info)
        if j + 1 < k:
            col = a[:, j + 1:, j]
            a[:, j + 1:, j] = torch.where(zero[:, None], col, col / d[:, None])
            prod = a[:, j + 1:, j, None] * a[:, j, None, j + 1:]
            a[:, j + 1:, j + 1:] = a[:, j + 1:, j + 1:] - prod
    return a, perm, info


def lane_lu_solve_plain(LU: torch.Tensor, perm: torch.Tensor, b: torch.Tensor):
    """Solve with :func:`lane_lu_factor_plain`'s factors in K6's order: x =
    the rows of ``b`` (B, k) or (B, k, m) in ``perm``'s order, forward
    substitution with the unit lower triangle column by column, then back
    substitution from the last unknown, each x_j divided by U_jj before it
    is used. K6's twin; runs take LAPACK on the CPU."""
    vec = b.dim() == 2
    x = b[..., None] if vec else b
    k = LU.shape[-1]
    x = torch.gather(x, 1, perm.long()[..., None].expand(-1, -1, x.shape[-1])).clone()
    for j in range(k - 1):
        x[:, j + 1:] = x[:, j + 1:] - LU[:, j + 1:, j, None] * x[:, j, None, :]
    for j in reversed(range(k)):
        x[:, j] = x[:, j] / LU[:, j, j, None]
        if j:
            x[:, :j] = x[:, :j] - LU[:, :j, j, None] * x[:, j, None, :]
    return x[..., 0] if vec else x


# ------------------------------------------------------------ K6: the launches

def lane_lu_factor_cuda(A: torch.Tensor):
    """Launch K6's factor on the current stream, one block a lane, as
    :func:`lu_factor_plan` places it."""
    global lu_factor_launches
    B, k = A.shape[0], A.shape[-1]
    dt = cuda_build.float_dtype("lane_lu_factor", A)
    cuda_build.check_args("lane_lu_factor", A.device, {"A": (A, (B, k, k), dt)})
    LU = torch.empty_like(A)
    perm = torch.empty((B, k), dtype=torch.int32, device=A.device)
    info = torch.empty((B,), dtype=torch.int32, device=A.device)
    cuda_build.launch("lane_lu_factor", factor_launcher(A, LU, perm, info))
    lu_factor_launches += 1
    return LU, perm, info


def factor_launcher(A, LU, perm, info):
    """The C launch of K6's factor on checked buffers, as a call with no
    arguments: the wrapper makes it once; ``chip_smoke.py`` repeats it to
    time the kernel without the wrapper's host work."""
    B, k = A.shape[0], A.shape[-1]
    plan = lu_factor_plan(k, A.element_size())
    fn = getattr(_library(LU_SOURCE), f"lane_lu_factor_{_suffix(A.dtype)}")
    p = cuda_build.ptr
    args = (p(A), p(LU), p(perm), p(info), B, k, int(plan.instance == "shared"),
            plan.smem_bytes, cuda_build.stream_of(A))
    return lambda: fn(*args)


def lane_lu_solve_cuda(LU: torch.Tensor, perm: torch.Tensor, b: torch.Tensor):
    """Launch K6's solve on the current stream, one block a lane, as
    :func:`lu_solve_plan` places it."""
    global lu_solve_launches
    vec = b.dim() == 2
    bm = (b[..., None] if vec else b).contiguous()
    B, k, m = bm.shape
    dt = cuda_build.float_dtype("lane_lu_solve", LU)
    cuda_build.check_args("lane_lu_solve", LU.device, {
        "LU": (LU, (B, k, k), dt), "perm": (perm, (B, k), torch.int32),
        "b": (bm, (B, k, m), dt)})
    x = torch.empty_like(bm)
    cuda_build.launch("lane_lu_solve", solve_launcher(LU, perm, bm, x))
    lu_solve_launches += 1
    return x[..., 0] if vec else x


def solve_launcher(LU, perm, b, x):
    """The C launch of K6's solve on checked (B, k, m) buffers, as a call
    with no arguments (see :func:`factor_launcher`)."""
    B, k, m = b.shape
    plan = lu_solve_plan(k, m, LU.element_size())
    fn = getattr(_library(LU_SOURCE), f"lane_lu_solve_{_suffix(LU.dtype)}")
    p = cuda_build.ptr
    args = (p(LU), p(perm), p(b), p(x), B, k, m, int(plan.instance == "shared"),
            plan.smem_bytes, cuda_build.stream_of(LU))
    return lambda: fn(*args)


def lu_solve_nan(A: torch.Tensor, b: torch.Tensor, factor=None, solve=None) -> torch.Tensor:
    """Solve (..., k, k) ``A`` x = ``b`` ((..., k) or (..., k, m)) by K6's
    launches (``factor`` and ``solve`` default to :func:`lane_lu_factor_cuda`
    and :func:`lane_lu_solve_cuda`; the tests pass the twins), a lane whose
    factor met an exactly zero pivot giving nan, as ``solve_small``'s LU
    branch does."""
    k = A.shape[-1]
    vec = b.dim() == A.dim() - 1
    bm = b[..., None] if vec else b
    A3, b3, lead = flatten_lanes(A, bm)
    LU, perm, info = (factor or lane_lu_factor_cuda)(A3)
    x = (solve or lane_lu_solve_cuda)(LU, perm, b3)
    x = torch.where((info != 0)[:, None, None], torch.full_like(x, float("nan")), x)
    x = x.reshape(*lead, *bm.shape[-2:])
    return x[..., 0] if vec else x


# --------------------------------------------------------------- K7: products

def flatten_lanes(a: torch.Tensor, b: torch.Tensor):
    """``a (..., p, q)`` and ``b (..., q', m)`` with their batch axes
    broadcast and flattened into one: (a3 (N, p, q), b3 (N, q', m), the
    broadcast batch shape), a3 contiguous."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    n = math.prod(lead)
    a3 = a.expand(*lead, *a.shape[-2:]).reshape(n, *a.shape[-2:]).contiguous()
    b3 = b.expand(*lead, *b.shape[-2:]).reshape(n, *b.shape[-2:])
    return a3, b3, lead


def lane_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (..., p, q) @ b (..., q, m)`` in K7's order: each entry summed
    from +0 over ascending q, every product rounded before it is added.
    K7's twin; runs take BLAS on the CPU."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    s = torch.zeros((*lead, a.shape[-2], b.shape[-1]), dtype=a.dtype, device=a.device)
    for t in range(a.shape[-1]):
        s = s + a[..., :, t, None] * b[..., None, t, :]
    return s


def lane_matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch K7 on the current stream, one thread an output entry; the
    broadcast batch axes are flattened (and the operands made contiguous)
    here. Float64 only."""
    global matmul_launches
    if a.dtype != torch.float64 or b.dtype != torch.float64:
        raise TypeError(f"lane_matmul kernel takes float64, got {a.dtype} and {b.dtype}")
    p, q, m = a.shape[-2], a.shape[-1], b.shape[-1]
    if b.shape[-2] != q:
        raise ValueError(f"lane_matmul: shapes {tuple(a.shape)} and {tuple(b.shape)} "
                         "do not chain")
    a3, b3, lead = flatten_lanes(a, b)
    b3 = b3.contiguous()
    N = a3.shape[0]
    cuda_build.check_args("lane_matmul", a.device, {
        "a": (a3, (N, p, q), torch.float64), "b": (b3, (N, q, m), torch.float64)})
    out = torch.empty((N, p, m), dtype=torch.float64, device=a.device)
    if out.numel():
        cuda_build.launch("lane_matmul", matmul_launcher(a3, b3, out))
        matmul_launches += 1
    return out.reshape(*lead, p, m)


def matmul_launcher(a, b, out):
    """The C launch of K7 on checked (N, p, q) and (N, q, m) buffers, as a
    call with no arguments (see :func:`factor_launcher`)."""
    N, p, q = a.shape
    fn = _library(MATMUL_SOURCE).lane_matmul_f64
    ptr = cuda_build.ptr
    args = (ptr(a), ptr(b), ptr(out), N, p, q, b.shape[-1], cuda_build.stream_of(a))
    return lambda: fn(*args)
