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
from typing import NamedTuple

import torch

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "kernels"
# -Xptxas=-v only reports registers and spills per kernel (see build())
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: no multiply-add contraction: a kernel built so rounds every operation as
#: its twin does (K2, K3, K6, K7), so decisions at exact ties (a score equal
#: to its pivot, the two box exits of a direction) fall the same way on both
NO_FMA = ("--fmad=false",)
#: dynamic shared memory one block may use on an H100 (227 KB); the
#: launchers ask for more than 48 KB with cudaFuncSetAttribute
SMEM_LIMIT = 232_448


class Plan(NamedTuple):
    """How a wrapper launches its kernel at one shape: the instance, the
    lanes one block serves, the dynamic shared memory of a block (at most
    ``SMEM_LIMIT``), the elements of global workspace a lane needs
    (allocated by the wrapper with ``torch.empty``; 0 for none), where an
    instance has more than one memory layout which (``place``), and K2's
    candidate rows staged in shared memory."""
    instance: str
    lanes_per_block: int
    smem_bytes: int
    work_elems: int = 0
    place: int = 0
    stage_rows: int = 0


def nvcc() -> str:
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return found


def library_path(source: pathlib.Path, extra_flags=(), linked=()) -> pathlib.Path:
    """Where the shared library for this source, the sources linked with it,
    the shared headers of ``csrc/`` and these flags lives."""
    h = hashlib.sha256(source.read_bytes())
    for other in (*linked, *sorted(CSRC.glob("*.cuh"))):
        h.update(other.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


def _nvcc(args, source):
    proc = subprocess.run([nvcc(), *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build(source: pathlib.Path, extra_flags=(), linked=()) -> tuple[pathlib.Path, str]:
    """Compile ``source`` (with ``extra_flags`` after the common ones)
    unless its library is already built. The sources of ``linked`` are
    compiled with the common flags only and linked with it as relocatable
    device code (``-dc``), so a device function there keeps the default
    multiply-add contraction that ``extra_flags`` may turn off.

    Returns the library path and the compiler's output, which lists each
    kernel instance's registers and spills (empty when the library
    existed). The build writes to a temporary name and renames, so
    concurrent processes never load a half-written file."""
    out = library_path(source, extra_flags, linked)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    objs = [f"{tmp}.{k}.o" for k in range(1 + len(linked))]
    try:
        if not linked:
            log = _nvcc([*NVCC_FLAGS, *extra_flags, "-o", tmp, str(source)], source)
        else:
            common = [f for f in NVCC_FLAGS if f != "-shared"]
            log = "".join(_nvcc([*common, *flags, "-dc", "-o", obj, str(src)], src)
                          for obj, (src, flags) in zip(
                              objs, ((source, extra_flags), *((s, ()) for s in linked))))
            log += _nvcc([*NVCC_FLAGS[:2], "-shared", "-Xcompiler", "-fPIC", "-o", tmp,
                          *objs], source)
        os.replace(tmp, out)
    finally:
        for path in (tmp, *objs):
            if os.path.exists(path):
                os.unlink(path)
    return out, log


def load(source: pathlib.Path, signatures: dict, extra_flags=(), linked=()) -> ctypes.CDLL:
    """Build ``source`` (and ``linked``, as :func:`build`) if needed and
    load it; ``signatures`` maps each exported function to its
    ``argtypes`` (a launch, returning its ``cudaError_t`` as an int) or to
    ``(argtypes, restype)``."""
    path, _ = build(source, extra_flags, linked)
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
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


#: cudaErrorMemoryAllocation: among other things, a launch whose local
#: memory (the stack frames ptxas reports, reserved for every thread the
#: card can hold) the driver could not allocate
CUDA_ERROR_MEMORY_ALLOCATION = 2


def launch(kernel: str, call) -> None:
    """Run ``call``, a C launcher that returns a ``cudaError_t``. A launch
    the driver found no memory for, while PyTorch's caching allocator held
    the card's free memory, is made once more after the cached blocks are
    released (the failed launch ran nothing); any other error, or a second
    failure, raises."""
    err = call()
    if err == CUDA_ERROR_MEMORY_ALLOCATION:
        torch.cuda.empty_cache()
        err = call()
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {err}")
