"""Fixed-trip ADMM stage loop: the CUDA kernel K1 and its plain twin.

Counterpart of ``morbit_tpu/ops/qp_lane.py``. :func:`admm_stages` runs all
``n_stages`` rho-stages of :func:`morbit_tpu_torch.ops.qp.solve_qp` for a
batch of tiny QPs and returns ``(z, zz, y)``:

* on CUDA tensors it launches the hand-written kernel in
  ``morbit_tpu_torch/csrc/qp_admm.cu`` (every stage and splitting step in
  one launch: one thread per lane at the main paths' shapes, one warp per
  lane working from shared memory at every other shape), built with
  ``nvcc`` at first use into ``build/kernels/`` and loaded with ``ctypes``;
* on CPU tensors it runs :func:`admm_stages_plain`, the batched torch
  version of the JAX package's ``_make_stage`` loop (``ops/qp.py:40-110``).

There is no fallback between the two: a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from morbit_tpu_torch.ops import cuda_build
from morbit_tpu_torch.ops.batched_linalg import (GJ_MAX_K, chol_factor,
                                                 chol_solve)

#: largest problem the kernel takes (a lane's variables and its rows spread
#: over one warp, two rows a thread; the 30-variable descent LP with three
#: objectives has nv = 31, m = 63)
MAX_NV, MAX_M = 32, 64
#: shapes of the one-thread-per-lane register instances
REGISTER_SHAPES = ((3, 6), (4, 8))
#: lanes (warps) in a block of the wide instance (``kLanesPerBlock``)
ADMM_LANES_PER_BLOCK = 4
#: infinite bounds become +-BIG inside the kernel (identical clip behavior)
BIG = 1e30

#: kernel launches since the counter was last set to 0 (the wrapper adds one
#: per launch; callers reset it to prove a run went through the kernel)
launches = 0

SOURCE = cuda_build.CSRC / "qp_admm.cu"

_lib = None


# ------------------------------------------------------------------ plain twin

def _chol(M, unroll: bool):
    """Cholesky with a per-lane breakdown flag; failed lanes come back as
    nan, like ``jnp.linalg.cholesky``."""
    if unroll:
        L = chol_factor(M)
        return L, ~torch.isfinite(L).all(-1).all(-1)
    L, info = torch.linalg.cholesky_ex(M)
    bad = (info != 0) | ~torch.isfinite(L).all(-1).all(-1)
    return torch.where(bad[..., None, None], torch.full_like(L, float("nan")),
                       L), bad


def _chol_solve(L, rhs, unroll: bool):
    if unroll:
        return chol_solve(L, rhs)
    return torch.cholesky_solve(rhs[..., None], L)[..., 0]


def admm_stages_plain(P, q, A, l, u, rho0, *, n_stages: int, n_steps: int,
                      sigma: float, alpha: float, rho_lo: float,
                      rho_hi: float):
    """Batched twin of the JAX package's fixed-trip stage loop
    (``_make_stage``, ``morbit_tpu/ops/qp.py:40-110``), same formulas and
    order. At <= 32 bits and ``nv <= GJ_MAX_K`` the factorization is the
    unrolled ``chol_factor``/``chol_solve``, as ``unroll_chol`` selects in
    JAX (qp.py:202); otherwise ``torch.linalg`` Cholesky."""
    B, nv = q.shape
    m = A.shape[-2]
    dtype = q.dtype
    unroll = torch.finfo(dtype).bits <= 32 and nv <= GJ_MAX_K
    At = A.transpose(-1, -2)
    eye = torch.eye(nv, dtype=dtype, device=q.device)
    z = torch.zeros_like(q)
    zz = torch.clamp(torch.zeros_like(l), l, u)
    y = torch.zeros_like(l)
    rho = rho0
    for _ in range(n_stages):
        M = P + sigma * eye + (At * rho[..., None, :]) @ A
        L, bad = _chol(M, unroll)
        jitter = 1e-3 * (M.diagonal(dim1=-2, dim2=-1).sum(-1) / nv + 1.0)
        L2, _ = _chol(M + jitter[..., None, None] * eye, unroll)
        L = torch.where(bad[..., None, None], L2, L)
        for _ in range(n_steps):
            rhs = sigma * z - q + (At @ (rho * zz - y)[..., None])[..., 0]
            xt = _chol_solve(L, rhs, unroll)
            zt = (A @ xt[..., None])[..., 0]
            z_new = alpha * xt + (1 - alpha) * z
            zz_new = torch.clamp(alpha * zt + (1 - alpha) * zz + y / rho, l, u)
            y = y + rho * (alpha * zt + (1 - alpha) * zz - zz_new)
            z, zz = z_new, zz_new
        # residuals -> rho rescale for the next stage's factorization
        Az = (A @ z[..., None])[..., 0]
        pr = (Az - zz).abs().amax(-1) if m else torch.zeros_like(q[..., 0])
        dr = ((P @ z[..., None])[..., 0] + q
              + (At @ y[..., None])[..., 0]).abs().amax(-1)
        scale = torch.sqrt(torch.clamp(pr, min=1e-30) / torch.clamp(dr, min=1e-30))
        scale = torch.clamp(scale, 0.1, 10.0)
        rho = torch.clamp(rho * scale[..., None], rho_lo, rho_hi)
    return z, zz, y


# ---------------------------------------------------------------- CUDA kernel

def build():
    """Compile ``csrc/qp_admm.cu`` unless it is built (see
    :func:`morbit_tpu_torch.ops.cuda_build.build`)."""
    return cuda_build.build(SOURCE)


def admm_smem_bytes(nv: int, m: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the kernel at (nv, m): 0 for
    the register instances; for the wide instance ``ADMM_LANES_PER_BLOCK``
    lanes of A (m x nv), P and two nv x nv stage matrices with rows padded
    to an odd stride, and six vectors (``wide_layout`` in the source)."""
    if (nv, m) in REGISTER_SHAPES:
        return 0
    ld = nv | 1
    lane = (m + 3 * nv) * ld + 3 * m + 3 * nv
    return ADMM_LANES_PER_BLOCK * lane * itemsize


def _library():
    global _lib
    if _lib is None:
        argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                    + [ctypes.c_double] * 4 + [ctypes.c_longlong, ctypes.c_void_p])
        _lib = cuda_build.load(SOURCE, {"qp_admm_f32": argtypes,
                                        "qp_admm_f64": argtypes})
    return _lib


def admm_stages_cuda(P, q, A, l, u, rho0, *, n_stages: int, n_steps: int,
                     sigma: float, alpha: float, rho_lo: float,
                     rho_hi: float):
    """Launch the ``qp_admm`` kernel on the current stream."""
    global launches
    B, nv = q.shape
    m = A.shape[-2]
    dt = cuda_build.float_dtype("qp_admm", q)
    smem = admm_smem_bytes(nv, m, q.element_size())
    if nv > MAX_NV or m > MAX_M or smem > cuda_build.SMEM_LIMIT:
        raise NotImplementedError(
            f"qp_admm kernel takes nv <= {MAX_NV} and m <= {MAX_M} within "
            f"{cuda_build.SMEM_LIMIT} bytes of shared memory, got nv={nv}, m={m}")
    cuda_build.check_args("qp_admm", q.device, {
        "P": (P, (B, nv, nv), dt), "q": (q, (B, nv), dt), "A": (A, (B, m, nv), dt),
        "l": (l, (B, m), dt), "u": (u, (B, m), dt), "rho0": (rho0, (B, m), dt)})
    l_s = torch.clamp(l, -BIG, BIG)
    u_s = torch.clamp(u, -BIG, BIG)
    z = torch.empty_like(q)
    zz = torch.empty_like(l)
    y = torch.empty_like(l)
    fn = _library().qp_admm_f32 if dt == torch.float32 else _library().qp_admm_f64
    ptr = cuda_build.ptr
    err = fn(ptr(P), ptr(q), ptr(A), ptr(l_s), ptr(u_s), ptr(rho0),
             ptr(z), ptr(zz), ptr(y), B, nv, m, n_stages, n_steps,
             sigma, alpha, rho_lo, rho_hi, smem, cuda_build.stream_of(q))
    if err != 0:
        raise RuntimeError(f"qp_admm kernel launch failed: cudaError_t {err}")
    launches += 1
    return z, zz, y


def admm_stages(P, q, A, l, u, rho0, **kw):
    """All rho-stages of the fixed-trip ADMM for a batch of QPs.

    CPU tensors take :func:`admm_stages_plain`; CUDA tensors launch the
    kernel (:func:`admm_stages_cuda`) or raise."""
    if q.device.type == "cpu":
        return admm_stages_plain(P, q, A, l, u, rho0, **kw)
    return admm_stages_cuda(P, q, A, l, u, rho0, **kw)
