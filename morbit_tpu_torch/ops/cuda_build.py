"""Build and load the port's hand-written CUDA kernels.

Each source in ``morbit_tpu_torch/csrc/`` has a plain C interface. At first
use it is compiled with ``nvcc`` into ``build/kernels/`` (named by a hash of
the source and the flags, so an edit rebuilds) and loaded with ``ctypes``.
Nothing is built at import time: the CPU tests import every module.
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

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "kernels"
# -Xptxas=-v only reports registers and spills per kernel (see build())
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: dynamic shared memory one block may use on an H100 (227 KB); the
#: launchers ask for more than 48 KB with cudaFuncSetAttribute
SMEM_LIMIT = 232_448


def nvcc() -> str:
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return found


def library_path(source: pathlib.Path, extra_flags=()) -> pathlib.Path:
    """Where the shared library for this source, the shared headers of
    ``csrc/`` and these flags lives."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


def build(source: pathlib.Path, extra_flags=()) -> tuple[pathlib.Path, str]:
    """Compile ``source`` (with ``extra_flags`` after the common ones)
    unless its library is already built.

    Returns the library path and the compiler's output, which lists each
    kernel instance's registers and spills (empty when the library
    existed). The build writes to a temporary name and renames, so
    concurrent processes never load a half-written file."""
    out = library_path(source, extra_flags)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
                               str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def load(source: pathlib.Path, signatures: dict, extra_flags=()) -> ctypes.CDLL:
    """Build ``source`` if needed and load it; ``signatures`` maps each
    exported function to its ``argtypes`` (a launch, returning its
    ``cudaError_t`` as an int) or to ``(argtypes, restype)``."""
    path, _ = build(source, extra_flags)
    lib = ctypes.CDLL(str(path))
    for name, spec in signatures.items():
        argtypes, restype = spec if isinstance(spec, tuple) else (spec, ctypes.c_int)
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def float_dtype(kernel: str, t):
    """The kernels are instantiated at float32 and float64."""
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel} kernel takes float32 or float64, got {t.dtype}")
    return t.dtype


def check_args(kernel: str, device, specs: dict) -> None:
    """Raise unless every ``name: (tensor, shape, dtype)`` of ``specs`` has
    that shape and dtype, lies on ``device`` (a CUDA device) and is
    contiguous."""
    for name, (t, shape, dtype) in specs.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                             f"{device} (cuda)")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device."""
    with torch.cuda.device(t.device):
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
