"""Where K5's warp-per-instance kernel spends its time, phase by phase.

Builds an instrumented copy of this checkout's ``csrc/admm_iterations.cu``
in which thread 0 of each warp (one instance) reads ``clock64()`` at the
kernel's phase comments (``---- rhs_j``, ``---- xt_i``, ``---- zt_r``,
``---- per row``) and before its outputs, and adds the cycles since the
previous mark to that mark's phase: prologue (staging in shared memory),
then per step the three sums and the row updates, each with the
``__syncwarp`` that ends it. The launch goes through the wrapper
(``dense_kernels.admm_iterations_cuda``) with the instrumented library in
place of the built one, on ``chip_smoke.admm_iterations_case`` at (3, 6),
(21, 42) and (64, 128), 100 steps, float32 and float64, with B=1024 (all
lanes resident, ~8 an SM) and B=4 (one block: a lane without neighbours).
One JSON line per set::

    python3 -m morbit_tpu_torch.tools.admm_iterations_phases

Needs a CUDA card. The cycles are the SM's, averaged over the lanes; the
event-timed launch of the uninstrumented kernel is printed beside them.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

try:
    from . import _clock_probe
except ImportError:  # run as a file
    import _clock_probe

#: the marks: (comment in the kernel, the phase it opens); a mark's cycles
#: run to the next mark
_ANCHORS = (("// ---- rhs_j", "rhs"), ("// ---- xt_i", "xt"), ("// ---- zt_r", "zt"),
            ("// ---- per row", "update"))
PHASES = ("prologue",) + tuple(name for _, name in _ANCHORS)
_SLOTS = 8
_END = "// ---- outputs"


def instrument(src: str) -> str:
    """The source with the probes in the kernel: a mark before each phase
    comment and the end before the outputs, each once."""
    text = _clock_probe.instrument(
        src, "admm_iterations_kernel", tuple(a for a, _ in _ANCHORS), end=re.escape(_END),
        include="#include <cuda_runtime.h>", name="k5", leader="(threadIdx.x & 31) == 0",
        slot="b", slots=_SLOTS)
    marks = [f"MORBIT_PROBE({k});" for k in range(1, len(PHASES))] + ["MORBIT_PROBE_END;"]
    for mark in marks:
        if text.count(mark) != 1:
            raise RuntimeError(f"{mark} not once in the kernel")
    return text


def phases() -> list:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from morbit_tpu_torch.ops import cuda_build, dense_kernels

    src = dense_kernels.ADMM_ITERATIONS_SOURCE
    lib = _clock_probe.build(instrument(src.read_text()), "k5", cuda_build,
                             dense_kernels._SIGNATURES[src])
    built = dense_kernels._library(src)
    kw = dict(iters=100, sigma=1e-6, alpha=1.6)
    rows = []
    for dtype in (torch.float32, torch.float64):
        for (n, m), B in [((3, 6), 1024), ((21, 42), 1024), ((21, 42), 4),
                          ((64, 128), 1024)]:
            args = [torch.as_tensor(a, dtype=dtype, device="cuda")
                    for a in cs.admm_iterations_case(B, n, m, seed=n)]
            dense_kernels._libs[src] = built
            out = dense_kernels.admm_iterations_cuda(*args, **kw)
            ms = cs.event_ms(lambda: dense_kernels.admm_iterations_cuda(*args, **kw), 10,
                             inner=5)
            prof = torch.zeros((B, _SLOTS), dtype=torch.int64, device="cuda")
            _clock_probe.attach(lib, "k5", prof)
            dense_kernels._libs[src] = lib
            out_p = dense_kernels.admm_iterations_cuda(*args, **kw)
            probed_ms = cs.event_ms(lambda: dense_kernels.admm_iterations_cuda(*args, **kw),
                                    3, inner=5)
            dense_kernels._libs[src] = built
            torch.cuda.synchronize()
            p = prof[:, :len(PHASES)].double().cpu()
            mean = p.mean(0)
            rows.append(dict(
                dtype=str(dtype), n=n, m=m, B=B, iters=kw["iters"], ms=ms,
                probed_ms=probed_ms,
                same_as_unprobed=all(torch.equal(a, b) for a, b in zip(out, out_p)),
                prologue_cycles=float(mean[0]),
                cycles_per_step={PHASES[i]: float(mean[i]) / kw["iters"]
                                 for i in range(1, len(PHASES))},
                step_cycles=float(mean[1:].sum()) / kw["iters"],
                lane_cycles_max=int(p.sum(1).max())))
    return rows


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for row in phases():
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
