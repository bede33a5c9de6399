"""Fixed-trip ADMM stage loop: the CUDA kernel K1 and its plain twin.

Counterpart of ``morbit_tpu/ops/qp_lane.py``. :func:`admm_stages` runs all
``n_stages`` rho-stages of :func:`morbit_tpu_torch.ops.qp.solve_qp` for a
batch of tiny QPs and returns ``(z, zz, y)``:

* on CUDA tensors it launches the hand-written kernel in
  ``morbit_tpu_torch/csrc/qp_admm.cu`` (one thread per lane, every stage and
  splitting step in one launch), built with ``nvcc`` at first use into
  ``build/kernels/`` and loaded with ``ctypes``;
* on CPU tensors it runs :func:`admm_stages_plain`, the batched torch
  version of the JAX package's ``_make_stage`` loop (``ops/qp.py:40-110``).

There is no fallback between the two: a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

from morbit_tpu_torch.ops.batched_linalg import (GJ_MAX_K, chol_factor,
                                                 chol_solve)

#: largest problem the kernel takes (its per-thread arrays are sized by these)
MAX_NV, MAX_M = 8, 24
#: infinite bounds become +-BIG inside the kernel (identical clip behavior)
BIG = 1e30

#: kernel launches since the counter was last set to 0 (the wrapper adds one
#: per launch; callers reset it to prove a run went through the kernel)
launches = 0

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "qp_admm.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
# -Xptxas=-v only reports registers and spills per kernel (see build())
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

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

def _nvcc() -> str:
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the qp_admm CUDA kernel cannot be built")
    return found


def library_path() -> pathlib.Path:
    """Where the shared library for this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return BUILD_DIR / f"libqp_admm_{h.hexdigest()[:12]}.so"


def build() -> tuple[pathlib.Path, str]:
    """Compile ``csrc/qp_admm.cu`` unless the library is already built.

    Returns the library path and the compiler's output, which lists each
    kernel instance's registers and spills (empty when the library
    existed). The build writes to a temporary name and renames, so
    concurrent processes never load a half-written file."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name in ("qp_admm_f32", "qp_admm_f64"):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                           + [ctypes.c_double] * 4 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def admm_stages_cuda(P, q, A, l, u, rho0, *, n_stages: int, n_steps: int,
                     sigma: float, alpha: float, rho_lo: float,
                     rho_hi: float):
    """Launch the ``qp_admm`` kernel on the current stream."""
    global launches
    B, nv = q.shape
    m = A.shape[-2]
    if nv > MAX_NV or m > MAX_M:
        raise NotImplementedError(
            f"qp_admm kernel takes nv <= {MAX_NV} and m <= {MAX_M}, got "
            f"nv={nv}, m={m}")
    if q.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"qp_admm kernel takes float32 or float64, got {q.dtype}")
    shapes = {"P": (P, (B, nv, nv)), "q": (q, (B, nv)), "A": (A, (B, m, nv)),
              "l": (l, (B, m)), "u": (u, (B, m)), "rho0": (rho0, (B, m))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"qp_admm: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"qp_admm: {name} is on {t.device}, expected {q.device} (cuda)")
        if t.dtype != q.dtype:
            raise TypeError(f"qp_admm: {name} is {t.dtype}, expected {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"qp_admm: {name} is not contiguous")
    l_s = torch.clamp(l, -BIG, BIG)
    u_s = torch.clamp(u, -BIG, BIG)
    z = torch.empty_like(q)
    zz = torch.empty_like(l)
    y = torch.empty_like(l)
    fn = _library().qp_admm_f32 if q.dtype == torch.float32 else _library().qp_admm_f64
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptr(P), ptr(q), ptr(A), ptr(l_s), ptr(u_s), ptr(rho0),
                 ptr(z), ptr(zz), ptr(y), B, nv, m, n_stages, n_steps,
                 sigma, alpha, rho_lo, rho_hi, ctypes.c_void_p(stream))
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
