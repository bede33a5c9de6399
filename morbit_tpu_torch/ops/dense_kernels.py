"""Dense kernels K4 (RBF Gram assembly) and K5 (ADMM splitting steps).

Counterpart of ``morbit_tpu/ops/pallas_kernels.py``, whose two Pallas
kernels become two hand-written CUDA kernels, batched over a leading lane
axis:

* :func:`rbf_gram_matrix` — the masked, identity-padded RBF Gram matrix of
  ``sites`` (B, P, n), the Pallas kernel ``rbf_gram_matrix`` (:71). CUDA
  tensors launch ``csrc/rbf_gram.cu``; CPU tensors take
  :func:`rbf_gram_matrix_plain`, the Pallas body in plain torch. ``fit_rbf``
  routes float32 fits with ``P >= 128`` here (the wide-n path).
* :func:`admm_iterations` — ``iters`` OSQP splitting steps with the KKT
  inverse given, the Pallas kernel ``admm_iterations`` (:78-138). CUDA
  tensors launch ``csrc/admm_iterations.cu``; CPU tensors take
  :func:`admm_iterations_plain`. Neither package calls it (the JAX
  package's ``ops/qp.py:47-52`` records it as superseded by K1).

There is no fallback between kernel and twin: a CUDA tensor launches the
kernel or raises. Each kernel is built with ``nvcc`` at first use
(:mod:`morbit_tpu_torch.ops.cuda_build`) and counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from morbit_tpu_torch.ops import cuda_build
from morbit_tpu_torch.ops.rbf import KERNEL_ID, apply_kernel, phi_constants

GRAM_SOURCE = cuda_build.CSRC / "rbf_gram.cu"
ADMM_ITERATIONS_SOURCE = cuda_build.CSRC / "admm_iterations.cu"
#: largest instance K5 takes (two variables and four rows a thread)
ADMM_ITERATIONS_MAX_N, ADMM_ITERATIONS_MAX_M = 64, 128
#: most instances (warps) in one block of K5
ADMM_ITERATIONS_MAX_LANES = 4

#: kernel launches since the counters were last set to 0 (each wrapper adds
#: one per launch; callers reset them to prove a run went through a kernel)
gram_launches = 0
admm_iterations_launches = 0

_SIGNATURES = {
    GRAM_SOURCE: {f"rbf_gram_{t}": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                  + [ctypes.c_double] * 2 + [ctypes.c_void_p] for t in ("f32", "f64")},
    ADMM_ITERATIONS_SOURCE: {
        f"admm_iterations_{t}": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
        + [ctypes.c_double] * 2
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        for t in ("f32", "f64")},
}
_libs = {}


def _library(source):
    if source not in _libs:
        _libs[source] = cuda_build.load(source, _SIGNATURES[source])
    return _libs[source]


def build_gram():
    return cuda_build.build(GRAM_SOURCE)


def build_admm_iterations():
    return cuda_build.build(ADMM_ITERATIONS_SOURCE)


# ------------------------------------------------------------ K4: Gram matrix

def rbf_gram_matrix_plain(sites, mask, kernel: str, param):
    """The Pallas body (``_gram_kernel``, ``pallas_kernels.py:36-49``) per
    lane: ``r^2 = max(|s_i|^2 + |s_j|^2 - 2 s_i.s_j, 0)``, then ``phi``,
    then the identity wherever either row is masked. ``param`` is a number
    (static for the exponent kernels) or a (B,) tensor."""
    P = sites.shape[-2]
    sq = (sites * sites).sum(-1, keepdim=True)                  # (B, P, 1)
    cross = sites @ sites.transpose(-1, -2)
    r2 = torch.clamp(sq + sq.transpose(-1, -2) - 2.0 * cross, min=0.0)
    phi = apply_kernel(kernel, r2, param)
    eye = torch.eye(P, dtype=sites.dtype, device=sites.device)
    return torch.where(mask[:, :, None] & mask[:, None, :], phi, eye)


def gram_smem_bytes(P: int, n: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of K4 (``gram_smem_bytes`` in the
    source): the lane's sites (P rounded up to 32 rows, each n rounded up to
    an odd number of 4-value vectors), their norms, eight 32 x 33 tile
    buffers and the mask."""
    rows = -(-P // 32) * 32
    ld = -(-n // 4) * 4
    ld += 4 if (ld // 4) % 2 == 0 else 0
    return itemsize * (rows * ld + rows + 8 * 32 * 33) + rows


def rbf_gram_cuda(sites, mask, kernel: str, param):
    """Launch the ``rbf_gram`` kernel on the current stream (one block per
    lane; the lane's sites must fit in shared memory). Returns a (B, P, P)
    view of a (B, P, ldo) buffer whose rows are padded to a multiple of 8
    values."""
    global gram_launches
    B, P, n = sites.shape
    dt = cuda_build.float_dtype("rbf_gram", sites)
    if gram_smem_bytes(P, n, sites.element_size()) > cuda_build.SMEM_LIMIT:
        raise NotImplementedError(
            f"rbf_gram kernel takes a lane's sites within {cuda_build.SMEM_LIMIT} "
            f"bytes of shared memory, got P={P}, n={n} at {dt}")
    param_t = (torch.full((B,), float(param), dtype=dt, device=sites.device)
               if isinstance(param, (int, float)) else param.contiguous())
    cuda_build.check_args("rbf_gram", sites.device, {
        "sites": (sites, (B, P, n), dt), "mask": (mask, (B, P), torch.bool),
        "param": (param_t, (B,), dt)})
    exponent, coef = phi_constants(kernel, param)
    # rows padded to a multiple of 8 values: every row starts on a 32-byte
    # sector, so the kernel's row segments are written as whole sectors
    ldo = -(-P // 8) * 8
    out = torch.empty((B, P, ldo), dtype=dt, device=sites.device)
    fn = getattr(_library(GRAM_SOURCE), "rbf_gram_f32" if dt == torch.float32
                 else "rbf_gram_f64")
    p = cuda_build.ptr
    err = fn(p(sites), p(mask), p(param_t), p(out), B, P, n, ldo, KERNEL_ID[kernel],
             exponent, coef, cuda_build.stream_of(sites))
    if err != 0:
        raise RuntimeError(f"rbf_gram kernel launch failed: cudaError_t {err}")
    gram_launches += 1
    return out[:, :, :P]


def rbf_gram_matrix(sites, mask, kernel: str, param):
    """Masked, identity-padded RBF Gram matrices (B, P, P) of ``sites``
    (B, P, n) with ``mask`` (B, P). CPU tensors take the plain twin, CUDA
    tensors launch K4 or raise."""
    if sites.device.type == "cpu":
        return rbf_gram_matrix_plain(sites, mask, kernel, param)
    return rbf_gram_cuda(sites, mask, kernel, param)


# --------------------------------------------------- K5: ADMM splitting steps

def admm_iterations_plain(Minv, A, rho, q, l, u, z0, zz0, y0, *, iters: int,
                          sigma: float, alpha: float):
    """``iters`` alpha-relaxed z/zz/y steps per lane, the Pallas body of
    ``admm_iterations`` (``pallas_kernels.py:105-119``) in the same order.
    ``Minv`` (B, n, n), ``A`` (B, m, n), vectors (B, n) or (B, m)."""
    z, zz, y = z0, zz0, y0
    At = A.transpose(-1, -2)
    for _ in range(iters):
        rhs = sigma * z - q + ((rho * zz - y)[:, None, :] @ A)[:, 0]
        xt = (rhs[:, None, :] @ Minv.transpose(-1, -2))[:, 0]
        zt = (xt[:, None, :] @ At)[:, 0]
        z_new = alpha * xt + (1.0 - alpha) * z
        zz_new = torch.clamp(alpha * zt + (1.0 - alpha) * zz + y / rho, l, u)
        y = y + rho * (alpha * zt + (1.0 - alpha) * zz - zz_new)
        z, zz = z_new, zz_new
    return z, zz, y


def _admm_iterations_lane_elems(n: int, m: int, itemsize: int) -> int:
    """Shared-memory elements of one K5 instance, mirroring ``layout`` in
    the source (whose launcher refuses any other size): A (m rows rounded
    up to whole 16-byte vectors) and Minv, each row padded to an odd count
    of vectors, t1, rhs and xt."""
    width = 16 // itemsize
    ld = -(-n // width) * width
    ld += width if (ld // width) % 2 == 0 else 0
    mp = -(-m // width) * width
    return (mp + n) * ld + mp + 2 * ld


def admm_iterations_lanes(n: int, m: int, itemsize: int) -> int:
    """Instances (warps) a block of K5 takes at (n, m): as many as fit the
    shared memory of a block, at most ``ADMM_ITERATIONS_MAX_LANES``."""
    lane = _admm_iterations_lane_elems(n, m, itemsize) * itemsize
    return max(1, min(ADMM_ITERATIONS_MAX_LANES, cuda_build.SMEM_LIMIT // lane))


def admm_iterations_smem_bytes(n: int, m: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of K5 at (n, m): the instances of
    :func:`admm_iterations_lanes`, each its A, Minv and three vectors."""
    return (admm_iterations_lanes(n, m, itemsize)
            * _admm_iterations_lane_elems(n, m, itemsize) * itemsize)


def admm_iterations_cuda(Minv, A, rho, q, l, u, z0, zz0, y0, *, iters: int,
                         sigma: float, alpha: float):
    """Launch the ``admm_iterations`` kernel on the current stream (one warp
    per instance, :func:`admm_iterations_lanes` instances a block)."""
    global admm_iterations_launches
    B, m, n = A.shape
    smem = admm_iterations_smem_bytes(n, m, A.element_size())
    if (n > ADMM_ITERATIONS_MAX_N or m > ADMM_ITERATIONS_MAX_M
            or smem > cuda_build.SMEM_LIMIT):
        raise NotImplementedError(
            f"admm_iterations kernel takes n <= {ADMM_ITERATIONS_MAX_N} and m <= "
            f"{ADMM_ITERATIONS_MAX_M} within {cuda_build.SMEM_LIMIT} bytes of shared "
            f"memory, got n={n}, m={m}")
    dt = cuda_build.float_dtype("admm_iterations", A)
    vecs = dict(rho=(rho, m), q=(q, n), l=(l, m), u=(u, m), z0=(z0, n),
                zz0=(zz0, m), y0=(y0, m))
    cuda_build.check_args("admm_iterations", A.device, {
        "Minv": (Minv, (B, n, n), dt), "A": (A, (B, m, n), dt),
        **{k: (t, (B, k_), dt) for k, (t, k_) in vecs.items()}})
    z, zz, y = torch.empty_like(z0), torch.empty_like(zz0), torch.empty_like(y0)
    fn = getattr(_library(ADMM_ITERATIONS_SOURCE),
                 "admm_iterations_f32" if dt == torch.float32 else "admm_iterations_f64")
    p = cuda_build.ptr
    err = fn(p(Minv), p(A), p(rho), p(q), p(l), p(u), p(z0), p(zz0), p(y0), p(z),
             p(zz), p(y), B, n, m, iters, sigma, alpha,
             admm_iterations_lanes(n, m, A.element_size()), smem, cuda_build.SMEM_LIMIT,
             cuda_build.stream_of(A))
    if err != 0:
        raise RuntimeError(f"admm_iterations kernel launch failed: cudaError_t {err}")
    admm_iterations_launches += 1
    return z, zz, y


def admm_iterations(Minv, A, rho, q, l, u, z0, zz0, y0, **kw):
    """``iters`` OSQP splitting steps for a batch of instances. CPU tensors
    take the plain twin, CUDA tensors launch K5 or raise."""
    if A.device.type == "cpu":
        return admm_iterations_plain(Minv, A, rho, q, l, u, z0, zz0, y0, **kw)
    return admm_iterations_cuda(Minv, A, rho, q, l, u, z0, zz0, y0, **kw)
