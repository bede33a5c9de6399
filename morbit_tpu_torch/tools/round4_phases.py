"""Where K3's block-per-lane instance spends its time, phase by phase.

Builds an instrumented copy of a checkout's ``csrc/rbf_round4.cu`` in which
thread 0 of each block reads ``clock64()`` at the wide kernel's phase
comments (``masked Householder QR``, ``---- tau^2 against the current
state``, ``---- accept``) and at its final ``N_out[b] = N``, and adds the
cycles since the previous mark to that mark's phase: set-up, QR, test,
accept. It also counts the candidates each lane tested and accepted. The
launch goes through the checkout's own wrapper (``prepare_fused.round4_cuda``)
with the instrumented library in place of the built one, on the inputs the
wide path gave K3 (``--record`` runs the wide path's first batch once and
saves them, ``--inputs`` loads them) and on ``chip_smoke.round4_case`` at
(231, 21, 2310) with the 300-row fill. One JSON line per checkout and set::

    python3 -m morbit_tpu_torch.tools.round4_phases [--record PATH] [--inputs PATH] [ROOT ...]

``ROOT`` is the root of a checkout (default: this one); each runs in its own
process. Needs a CUDA card. The cycles are the SM's; the event-timed launch
of the uninstrumented kernel is printed beside them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

#: the marks: (comment in the wide kernel, the phase it opens); a mark's
#: cycles run to the next mark. The first three are in every version of the
#: kernel (they count the tested and accepted candidates); the others split
#: the test and the acceptance where the kernel has them.
_ANCHORS = (("masked Householder QR", "qr"),
            ("---- tau^2 against the current state", "test"),
            ("---- accept", "accept"),
            ("// Qg = Q[:, :pd] g", "test_qg"),
            ("// PQg = Phi Qg", "test_pqg"),
            ("// qpq and pq", "test_v"),
            ("// Lv = L^-1 v", "test_lv"),
            ("// the decision:", "test_decide"),
            ("// Q <- blkdiag(Q, 1) G': the same rotations on the pd", "accept_q"),
            ("// the new row of L^-1", "accept_l"))
PHASES = ("setup",) + tuple(name for _, name in _ANCHORS)
_TEST, _ACCEPT = PHASES.index("test"), PHASES.index("accept")
_SLOTS = 16

_PROBE_HEAD = r"""
__device__ long long* g_round4_probe = nullptr;
extern "C" int round4_probe_set(long long* p) {
  return (int)cudaMemcpyToSymbol(g_round4_probe, &p, sizeof(p));
}
#define MORBIT_PROBE(k)                                                  \
  if (threadIdx.x == 0) {                                                \
    const long long _t = clock64();                                      \
    _pa[_pp] += _t - _pt;                                                \
    _pt = _t;                                                            \
    _pp = (k);                                                           \
    if ((k) == MORBIT_TEST) ++_pc[0];                                    \
    if ((k) == MORBIT_ACCEPT) ++_pc[1];                                  \
  }
#define MORBIT_PROBE_END                                                 \
  if (threadIdx.x == 0 && g_round4_probe) {                              \
    MORBIT_PROBE(0);                                                     \
    for (int _k = 0; _k < MORBIT_PHASES; ++_k)                           \
      g_round4_probe[blockIdx.x * MORBIT_SLOTS + _k] = _pa[_k];          \
    g_round4_probe[blockIdx.x * MORBIT_SLOTS + MORBIT_PHASES] = _pc[0];  \
    g_round4_probe[blockIdx.x * MORBIT_SLOTS + MORBIT_PHASES + 1] = _pc[1]; \
  }
"""
_PROBE_DECL = ("long long _pt = clock64(), _pa[MORBIT_PHASES] = {}; "
               "int _pp = 0, _pc[2] = {0, 0};")


def instrument(src: str) -> str:
    """The source with the probes in the wide kernel (its definition runs
    from ``rbf_round4_wide_kernel(`` to the first line that is a lone
    closing brace)."""
    start = re.search(r"rbf_round4_wide_kernel\(", src).start()
    body = src.index("{", src.index(")", start)) + 1
    stop = src.index("\n}\n", body)
    lines = src[body:stop].split("\n")
    out = [_PROBE_DECL]
    for line in lines:
        for k, (anchor, _) in enumerate(_ANCHORS, 1):
            if anchor in line:
                out.append(f"MORBIT_PROBE({k});")
        if re.search(r"N_out\[b\] = N;\s*$", line) and "return" not in line:
            out.append("MORBIT_PROBE_END;")
        out.append(line)
    inc = src.index('#include "rbf_phi.cuh"') + len('#include "rbf_phi.cuh"')
    sizes = (f"\n#define MORBIT_PHASES {len(PHASES)}\n#define MORBIT_SLOTS {_SLOTS}\n"
             f"#define MORBIT_TEST {_TEST}\n#define MORBIT_ACCEPT {_ACCEPT}\n")
    text = (src[:inc] + sizes + _PROBE_HEAD + src[inc:body] + "\n".join(out)
            + src[stop:])
    for anchor, _ in _ANCHORS[:3]:
        if anchor not in src[body:stop]:
            raise RuntimeError(f"anchor {anchor!r} not in the wide kernel")
    return text


def _instrumented_library(prepare_fused, cuda_build):
    """Build the instrumented copy of this checkout's K3 source and load it
    with the wrapper's own signatures."""
    import hashlib

    src = instrument(prepare_fused.ROUND4_SOURCE.read_text())
    out_dir = cuda_build.BUILD_DIR.parent / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(src.encode()).hexdigest()[:12]
    cu, so = out_dir / f"round4_probe_{tag}.cu", out_dir / f"round4_probe_{tag}.so"
    cu.write_text(src)
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS,
                           *prepare_fused.NO_FMA, "-I", str(cuda_build.CSRC),
                           "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    for name, spec in prepare_fused._SIGNATURES[prepare_fused.ROUND4_SOURCE].items():
        argtypes, restype = spec if isinstance(spec, tuple) else (spec, ctypes.c_int)
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    lib.round4_probe_set.argtypes = [ctypes.c_void_p]
    return lib


def record(path: str) -> None:
    """Run the wide path's first batch (as ``chip_smoke.py`` does) and save
    the K3 inputs of its recorded calls: candidate rows only (the
    others zeroed, which changes no output), up to the last candidate
    column of any lane."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from morbit_tpu_torch import AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.problems.synthetic import halton_starts

    mop = cs.wide_mop()
    x0 = torch.as_tensor(halton_starts(cs.B_WIDE, mop.lb, mop.ub, 1),
                         dtype=torch.float32, device="cuda")
    captured = {"round4": []}
    with cs.recording(captured, cs.WIDE_CAPTURE_CALLS):
        multistart_optimize(mop, x0, AlgorithmConfig(**cs.WIDE_BUDGET), dtype=torch.float32)
    arrays = {}
    for t, (a, kw) in zip(cs.WIDE_CAPTURE_CALLS, captured["round4"]):
        X, cand, init, count = a
        last = int(cand.any(0).nonzero().max()) + 1 if bool(cand.any()) else 1
        Xc = torch.where(cand[:, :last, None], X[:, :last], torch.zeros((), device="cuda"))
        arrays.update({f"r4_{t}_X": Xc.cpu().numpy(), f"r4_{t}_cand": cand[:, :last].cpu().numpy(),
                       f"r4_{t}_init": init.cpu().numpy(), f"r4_{t}_count": count.cpu().numpy(),
                       f"r4_{t}_C": np.int64(X.shape[1]),
                       f"r4_{t}_kw": np.array(json.dumps(
                           {k: (v if not isinstance(v, torch.Tensor) else None)
                            for k, v in kw.items()}))})
    np.savez_compressed(path, **arrays)


def load_round4(path: str, dtype):
    """The recorded K3 calls of ``record`` as (name, args, kw), restored to
    their full candidate width."""
    import numpy as np
    import torch

    z = np.load(path)
    sets = []
    for key in sorted(k for k in z.files if k.startswith("r4_") and k.endswith("_X")):
        t = key.split("_")[1]
        X, cand = z[f"r4_{t}_X"], z[f"r4_{t}_cand"]
        C = int(z[f"r4_{t}_C"])
        B, last, n = X.shape
        Xf = np.zeros((B, C, n), X.dtype)
        Xf[:, :last] = X
        cf = np.zeros((B, C), bool)
        cf[:, :last] = cand
        f = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
        args = (f(Xf), torch.as_tensor(cf, device="cuda"), f(z[f"r4_{t}_init"]),
                torch.as_tensor(z[f"r4_{t}_count"], dtype=torch.int32, device="cuda"))
        sets.append((f"wide_path_call{t}", args, json.loads(str(z[f"r4_{t}_kw"]))))
    return sets


def random_wide(dtype):
    """``chip_smoke.round4_case`` at the wide shapes with the 300-row fill,
    as ``chip_smoke.py``'s ``random_wide_cubic_deg1`` set."""
    import numpy as np
    import torch

    import chip_smoke as cs

    X, cand, init, count, _ = cs.round4_case(np.random.default_rng(11), cs.B_MAIN, 2310,
                                             cs.N_WIDE, cs.WIDE_MAX_POINTS, 0.4,
                                             cs.WIDE_MAX_POINTS + cs.N_WIDE)
    fill = np.random.default_rng(12).integers(cs.N_WIDE + 1, 300, cs.B_MAIN)
    cand &= np.arange(2310)[None, :] < fill[:, None]
    f = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    args = (f(X), torch.as_tensor(cand, device="cuda"), f(init),
            torch.as_tensor(count, dtype=torch.int32, device="cuda"))
    kw = dict(kernel="cubic", param=3, poly_deg=1, max_points=cs.WIDE_MAX_POINTS,
              chol_pivot=1e-14)
    return "random_wide_cubic_deg1", args, kw


def phases_here(inputs) -> list:
    sys.path.insert(0, os.getcwd())
    import statistics

    import torch

    import chip_smoke as cs
    from morbit_tpu_torch.ops import cuda_build, prepare_fused

    lib = _instrumented_library(prepare_fused, cuda_build)
    built = prepare_fused._library(prepare_fused.ROUND4_SOURCE)
    rows = []
    for dtype in (torch.float32, torch.float64):
        sets = (load_round4(inputs, dtype) if inputs else []) + [random_wide(dtype)]
        for name, args, kw in sets:
            B = args[0].shape[0]
            prepare_fused._libs[prepare_fused.ROUND4_SOURCE] = built
            acc, N = prepare_fused.round4_cuda(*args, **kw)
            ms = cs.event_ms(lambda: prepare_fused.round4_cuda(*args, **kw), 5)
            prof = torch.zeros((B, _SLOTS), dtype=torch.int64, device="cuda")
            check = lib.round4_probe_set(prof.data_ptr())
            if check != 0:
                raise RuntimeError(f"cudaMemcpyToSymbol: {check}")
            prepare_fused._libs[prepare_fused.ROUND4_SOURCE] = lib
            acc_p, N_p = prepare_fused.round4_cuda(*args, **kw)
            probed_ms = cs.event_ms(lambda: prepare_fused.round4_cuda(*args, **kw), 3)
            prepare_fused._libs[prepare_fused.ROUND4_SOURCE] = built
            torch.cuda.synchronize()
            p = prof.cpu()
            k = len(PHASES)
            lane_total = p[:, :k].sum(-1)
            worst = int(lane_total.argmax())
            tested, accepted = p[:, k], p[:, k + 1]
            seen = [i for i in range(k) if bool((p[:, i] != 0).any())]
            rows.append(dict(
                set=name, dtype=str(dtype), ms=ms, probed_ms=probed_ms,
                same_as_unprobed=bool(torch.equal(acc, acc_p) and torch.equal(N, N_p)),
                cycles_share={PHASES[i]: float(p[:, i].sum() / max(1, int(lane_total.sum())))
                              for i in seen},
                worst_lane=worst, worst_lane_cycles={PHASES[i]: int(p[worst, i])
                                                     for i in seen},
                worst_lane_tested=int(tested[worst]), worst_lane_accepted=int(accepted[worst]),
                tested_max=int(tested.max()), tested_median=statistics.median(tested.tolist()),
                accepted_max=int(accepted.max()),
                accepted_median=statistics.median(accepted.tolist()),
                tested_total=int(tested.sum()), accepted_total=int(accepted.sum()),
                N0_max=int(args[3].max()), N0_median=statistics.median(args[3].tolist()),
                N_final_max=int(N.max()), N_final_median=statistics.median(N.tolist())))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--record", help="run the wide path's first batch and save its "
                    "K3/K4 inputs here first")
    ap.add_argument("--inputs", help="recorded inputs (from --record)")
    ap.add_argument("--here", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.here:
        for row in phases_here(args.inputs):
            print(json.dumps(row), flush=True)
        return 0
    if args.record:
        sys.path.insert(0, os.getcwd())
        record(args.record)
        args.inputs = args.inputs or args.record
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    me = os.path.abspath(__file__)
    for root in args.roots:
        root = os.path.abspath(root)
        cmd = [sys.executable, me, "--here"]
        if args.inputs:
            cmd += ["--inputs", os.path.abspath(args.inputs)]
        run = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-3000:], file=sys.stderr)
            return run.returncode
        for line in run.stdout.strip().splitlines():
            print(json.dumps({"checkout": root, **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
