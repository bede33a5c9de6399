"""clock64 phase probes in an instrumented copy of a kernel's source.

The leading thread of each instance keeps the cycles between marks:
``MORBIT_PROBE(k)`` adds the cycles since the previous mark to the phase
that mark opened and opens phase k (phase 0 runs from the kernel's entry to
the first mark); ``MORBIT_PROBE_END`` closes the last phase and writes the
instance's cycles per phase, then how often each counted mark was passed,
to row ``slot`` of the int64 array given to ``<name>_probe_set``. Used by
``round4_phases`` (K3) and ``admm_iterations_phases`` (K5); it imports
nothing of the package, so a tool can probe another checkout's kernel with
that checkout's ``cuda_build``.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess

_DECL = "long long _pt = clock64(), _pa[MORBIT_PHASES + MORBIT_COUNTED] = {}; int _pp = 0;"


def _head(name: str, leader: str, slot: str, n_phases: int, slots: int,
          counted: tuple) -> str:
    count = "".join(f"    if ((k) == {k}) ++_pa[MORBIT_PHASES + {i}];\\\n"
                    for i, k in enumerate(counted))
    return (
        f"\n#define MORBIT_PHASES {n_phases}\n#define MORBIT_COUNTED {len(counted)}\n"
        f"__device__ long long* g_{name}_probe = nullptr;\n"
        f'extern "C" int {name}_probe_set(long long* p) {{\n'
        f"  return (int)cudaMemcpyToSymbol(g_{name}_probe, &p, sizeof(p));\n}}\n"
        f"#define MORBIT_PROBE(k)\\\n"
        f"  if ({leader}) {{\\\n"
        f"    const long long _t = clock64();\\\n"
        f"    _pa[_pp] += _t - _pt;\\\n"
        f"    _pt = _t;\\\n"
        f"    _pp = (k);\\\n"
        f"{count}"
        f"  }}\n"
        f"#define MORBIT_PROBE_END\\\n"
        f"  if (({leader}) && g_{name}_probe) {{\\\n"
        f"    MORBIT_PROBE(0);\\\n"
        f"    for (int _k = 0; _k < MORBIT_PHASES + MORBIT_COUNTED; ++_k)\\\n"
        f"      g_{name}_probe[(size_t)({slot}) * {slots} + _k] = _pa[_k];\\\n"
        f"  }}\n")


def instrument(src: str, kernel: str, anchors: tuple, *, end: str, include: str,
               name: str, leader: str, slot: str, slots: int, counted: tuple = (),
               required: int | None = None) -> str:
    """``src`` with probes in ``kernel``'s definition (from ``kernel(`` to
    the first line that is a lone closing brace): ``MORBIT_PROBE(k)`` before
    each line holding ``anchors[k - 1]``, ``MORBIT_PROBE_END`` before each
    line the regex ``end`` matches, the macros after ``include``. The first
    ``required`` anchors (all by default) must be in the kernel. ``leader``
    is the condition of the thread that probes, ``slot`` the instance's row,
    ``counted`` the marks whose passes are counted."""
    start = re.search(rf"{kernel}\(", src).start()
    body = src.index("{", src.index(")", start)) + 1
    stop = src.index("\n}\n", body)
    for anchor in anchors[:required]:
        if anchor not in src[body:stop]:
            raise RuntimeError(f"anchor {anchor!r} not in {kernel}")
    out = [_DECL]
    for line in src[body:stop].split("\n"):
        for k, anchor in enumerate(anchors, 1):
            if anchor in line:
                out.append(f"MORBIT_PROBE({k});")
        if re.search(end, line):
            out.append("MORBIT_PROBE_END;")
        out.append(line)
    if len(anchors) + 1 + len(counted) > slots:
        raise ValueError(f"{slots} slots cannot hold the phases and counts")
    at = src.index(include) + len(include)
    head = _head(name, leader, slot, len(anchors) + 1, slots, counted)
    return src[:at] + head + src[at:body] + "\n".join(out) + src[stop:]


def build(text: str, name: str, cuda_build, signatures: dict, flags=()) -> ctypes.CDLL:
    """Build the instrumented ``text`` with ``cuda_build``'s nvcc and flags
    (plus ``flags``) under its build directory's ``probe/`` and load it with
    the wrapper's ``signatures`` (as ``cuda_build.load`` takes them)."""
    out_dir = cuda_build.BUILD_DIR.parent / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    cu, so = out_dir / f"{name}_probe_{tag}.cu", out_dir / f"{name}_probe_{tag}.so"
    cu.write_text(text)
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *flags,
                           "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    for fn, spec in signatures.items():
        argtypes, restype = spec if isinstance(spec, tuple) else (spec, ctypes.c_int)
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    getattr(lib, f"{name}_probe_set").argtypes = [ctypes.c_void_p]
    return lib


def attach(lib: ctypes.CDLL, name: str, prof) -> None:
    """Point the library's probes at ``prof``, a (instances, slots) int64
    tensor on the card."""
    err = getattr(lib, f"{name}_probe_set")(prof.data_ptr())
    if err != 0:
        raise RuntimeError(f"cudaMemcpyToSymbol: {err}")
