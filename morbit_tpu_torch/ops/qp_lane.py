"""Fixed-trip ADMM stage loop: the CUDA kernel K1 and its plain twin.

Counterpart of ``morbit_tpu/ops/qp_lane.py``. :func:`admm_stages` runs all
``n_stages`` rho-stages of :func:`morbit_tpu_torch.ops.qp.solve_qp` for a
batch of tiny QPs and returns ``(z, zz, y)``:

* on CUDA tensors it launches the hand-written kernel in
  ``morbit_tpu_torch/csrc/qp_admm.cu`` (every stage and splitting step in
  one launch: one thread per lane at the main paths' shapes, one warp per
  lane working from shared memory up to nv = 32, m = 64, and above that one
  warp per lane with its variables and rows strided over the warp, its
  matrices in shared memory or, where a lane does not fit, in a workspace:
  :func:`admm_plan`), built with ``nvcc`` at first use into
  ``build/kernels/`` and loaded with ``ctypes``;
* on CPU tensors it runs :func:`admm_stages_plain`, the batched torch
  version of the JAX package's ``_make_stage`` loop (``ops/qp.py:40-110``).

:func:`admm_stages_exit` runs the same stages with the JAX package's
residual early exit (``solve_qp(exit_eps=)``, ``ops/qp.py:216-238``), per
lane: after a stage, a lane whose ``max(pr, dr)`` (the residuals of the rho
rescale) is not above ``exit_eps`` stops and keeps its carry. It also
returns the stages each lane ran. The fixed-trip path above is a separate
instance of the kernel, which tests nothing.

There is no fallback between the two: a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from morbit_tpu_torch.ops import cuda_build
from morbit_tpu_torch.ops.batched_linalg import (GJ_MAX_K, chol_factor,
                                                 chol_solve)
from morbit_tpu_torch.utils.tree import lane_where

#: largest shape of the warp instance (a lane's variables and its rows spread
#: over one warp, two rows a thread); the strided instance takes every other
WARP_MAX_NV, WARP_MAX_M = 32, 64
#: shapes of the one-thread-per-lane register instances
REGISTER_SHAPES = ((3, 6), (4, 8))
#: lanes (warps) in a block of the warp instance (``kLanesPerBlock``)
ADMM_LANES_PER_BLOCK = 4
#: lanes a block of the strided instance may take, in order of preference
STRIDED_LANES = (4, 2, 1)
#: the instances' codes in the C launcher
_INSTANCES = {"register": 0, "warp": 1, "strided": 2}
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
    return _stages_plain(P, q, A, l, u, rho0, n_stages=n_stages, n_steps=n_steps,
                         sigma=sigma, alpha=alpha, rho_lo=rho_lo, rho_hi=rho_hi)[:3]


def admm_stages_exit_plain(P, q, A, l, u, rho0, *, exit_eps: float, n_stages: int,
                           n_steps: int, sigma: float, alpha: float, rho_lo: float,
                           rho_hi: float):
    """Twin of the kernel's exit instance: the stages of
    :func:`admm_stages_plain`, a lane frozen (its carry masked) once
    ``max(pr, dr)`` after a stage is not above ``exit_eps``, as the JAX
    package's ``while_loop`` under ``vmap`` (NaN residuals exit too).
    Returns ``(z, zz, y, stages)``, ``stages`` the (B,) int32 stages each
    lane ran."""
    return _stages_plain(P, q, A, l, u, rho0, n_stages=n_stages, n_steps=n_steps,
                         sigma=sigma, alpha=alpha, rho_lo=rho_lo, rho_hi=rho_hi,
                         exit_eps=float(exit_eps))


def _stages_plain(P, q, A, l, u, rho0, *, n_stages, n_steps, sigma, alpha, rho_lo,
                  rho_hi, exit_eps=0.0):
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
    running = torch.ones((B,), dtype=torch.bool, device=q.device)
    stages = torch.zeros((B,), dtype=torch.int32, device=q.device)
    for s in range(n_stages):
        carry = (z, zz, y)
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
        if not exit_eps:
            continue
        # the exit: lanes that stopped before this stage keep their carry
        z, zz, y = (lane_where(running, a, b) for a, b in zip((z, zz, y), carry))
        stages = stages + running.to(torch.int32)
        running = running & (torch.maximum(pr, dr) > exit_eps)
        if s + 1 < n_stages and not bool(running.any()):
            break
    if not exit_eps:
        stages = torch.full_like(stages, n_stages)
    return z, zz, y, stages


# ---------------------------------------------------------------- CUDA kernel

def build():
    """Compile ``csrc/qp_admm.cu`` unless it is built (see
    :func:`morbit_tpu_torch.ops.cuda_build.build`)."""
    return cuda_build.build(SOURCE)


def _strided_lane(nv: int, m: int, place: int) -> tuple[int, int]:
    """A lane's matrix and vector elements in the strided instance
    (``strided_layout`` in the source): at place 0 A, P and the two stage
    matrices, rows padded to an odd stride; elsewhere the stage matrices
    only (A and P are read from the inputs); and seven vectors of m and four
    of nv."""
    ld = nv | 1
    mat = (m + 3 * nv) * ld if place == 0 else 2 * nv * ld
    return mat, 7 * m + 4 * nv


def admm_plan(nv: int, m: int, itemsize: int) -> cuda_build.Plan:
    """The launch at (nv, m): the register instances at their shapes (one
    thread a lane, 128 lanes a block); the warp instance up to
    ``WARP_MAX_NV`` x ``WARP_MAX_M`` where its block fits (four lanes a
    block; A (m x nv), P and two nv x nv stage matrices with rows padded to
    an odd stride, and six vectors, ``wide_layout`` in the source); every
    other shape the strided instance, with as many lanes of
    ``STRIDED_LANES`` as fit a block's shared memory: the whole lane there
    (place 0), else its vectors only with the stage matrices in the
    workspace (place 1), else nothing there (place 2, four lanes a
    block)."""
    if (nv, m) in REGISTER_SHAPES:
        return cuda_build.Plan("register", 128, 0)
    if nv <= WARP_MAX_NV and 1 <= m <= WARP_MAX_M:
        ld = nv | 1
        smem = ADMM_LANES_PER_BLOCK * ((m + 3 * nv) * ld + 3 * m + 3 * nv) * itemsize
        if smem <= cuda_build.SMEM_LIMIT:
            return cuda_build.Plan("warp", ADMM_LANES_PER_BLOCK, smem)
    mat, vec = _strided_lane(nv, m, 0)
    for lanes in STRIDED_LANES:
        if lanes * (mat + vec) * itemsize <= cuda_build.SMEM_LIMIT:
            return cuda_build.Plan("strided", lanes, lanes * (mat + vec) * itemsize)
    mat, vec = _strided_lane(nv, m, 1)
    for lanes in STRIDED_LANES:
        if lanes * vec * itemsize <= cuda_build.SMEM_LIMIT:
            return cuda_build.Plan("strided", lanes, lanes * vec * itemsize, mat, 1)
    return cuda_build.Plan("strided", STRIDED_LANES[0], 0, mat + vec, 2)


def _library():
    global _lib
    if _lib is None:
        argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                    + [ctypes.c_double] * 4 + [ctypes.c_int] * 3
                    + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
        # the exit instances take the stages buffer after y, exit_eps after rho_hi
        exit_types = argtypes[:9] + [ctypes.c_void_p] + argtypes[9:18] \
            + [ctypes.c_double] + argtypes[18:]
        _lib = cuda_build.load(SOURCE, {"qp_admm_f32": argtypes,
                                        "qp_admm_f64": argtypes,
                                        "qp_admm_exit_f32": exit_types,
                                        "qp_admm_exit_f64": exit_types})
    return _lib


def admm_stages_cuda(P, q, A, l, u, rho0, *, n_stages: int, n_steps: int,
                     sigma: float, alpha: float, rho_lo: float,
                     rho_hi: float):
    """Launch the ``qp_admm`` kernel's fixed-trip instance on the current
    stream."""
    return _launch(P, q, A, l, u, rho0, n_stages, n_steps, sigma, alpha, rho_lo,
                   rho_hi, 0.0)[:3]


def admm_stages_exit_cuda(P, q, A, l, u, rho0, *, exit_eps: float, n_stages: int,
                          n_steps: int, sigma: float, alpha: float, rho_lo: float,
                          rho_hi: float):
    """Launch the ``qp_admm`` kernel's exit instance on the current stream;
    returns ``(z, zz, y, stages)`` as :func:`admm_stages_exit_plain`."""
    if not exit_eps > 0:
        raise ValueError(f"the exit instance takes exit_eps > 0, got {exit_eps!r}")
    return _launch(P, q, A, l, u, rho0, n_stages, n_steps, sigma, alpha, rho_lo,
                   rho_hi, float(exit_eps))


def _launch(P, q, A, l, u, rho0, n_stages, n_steps, sigma, alpha, rho_lo, rho_hi,
            exit_eps):
    global launches
    B, nv = q.shape
    m = A.shape[-2]
    dt = cuda_build.float_dtype("qp_admm", q)
    plan = admm_plan(nv, m, q.element_size())
    cuda_build.check_args("qp_admm", q.device, {
        "P": (P, (B, nv, nv), dt), "q": (q, (B, nv), dt), "A": (A, (B, m, nv), dt),
        "l": (l, (B, m), dt), "u": (u, (B, m), dt), "rho0": (rho0, (B, m), dt)})
    l_s = torch.clamp(l, -BIG, BIG)
    u_s = torch.clamp(u, -BIG, BIG)
    z = torch.empty_like(q)
    zz = torch.empty_like(l)
    y = torch.empty_like(l)
    work = torch.empty((B * plan.work_elems,), dtype=dt, device=q.device)
    ptr = cuda_build.ptr
    head = (ptr(P), ptr(q), ptr(A), ptr(l_s), ptr(u_s), ptr(rho0), ptr(z), ptr(zz), ptr(y))
    dims = (B, nv, m, n_stages, n_steps, sigma, alpha, rho_lo, rho_hi)
    tail = (_INSTANCES[plan.instance], plan.lanes_per_block, plan.place, plan.smem_bytes,
            ptr(work) if plan.work_elems else None, cuda_build.stream_of(q))
    t = "f32" if dt == torch.float32 else "f64"
    if exit_eps:
        stages = torch.empty((B,), dtype=torch.int32, device=q.device)
        cuda_build.launch("qp_admm", lambda: getattr(_library(), f"qp_admm_exit_{t}")(
            *head, ptr(stages), *dims, exit_eps, *tail))
    else:
        stages = None
        cuda_build.launch("qp_admm", lambda: getattr(_library(), f"qp_admm_{t}")(
            *head, *dims, *tail))
    launches += 1
    return z, zz, y, stages


def admm_stages(P, q, A, l, u, rho0, **kw):
    """All rho-stages of the fixed-trip ADMM for a batch of QPs.

    CPU tensors take :func:`admm_stages_plain`; CUDA tensors launch the
    kernel (:func:`admm_stages_cuda`) or raise."""
    if q.device.type == "cpu":
        return admm_stages_plain(P, q, A, l, u, rho0, **kw)
    return admm_stages_cuda(P, q, A, l, u, rho0, **kw)


def admm_stages_exit(P, q, A, l, u, rho0, **kw):
    """The rho-stages with the per-lane residual exit (``exit_eps`` > 0):
    ``(z, zz, y, stages)``. CPU tensors take :func:`admm_stages_exit_plain`;
    CUDA tensors launch the kernel's exit instance
    (:func:`admm_stages_exit_cuda`) or raise."""
    if q.device.type == "cpu":
        return admm_stages_exit_plain(P, q, A, l, u, rho0, **kw)
    return admm_stages_exit_cuda(P, q, A, l, u, rho0, **kw)
