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
import json
import os
import subprocess
import sys

try:
    from . import _clock_probe
except ImportError:  # run as a file, as the child of another checkout does
    import _clock_probe

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
_SLOTS = 16


def instrument(src: str) -> str:
    """The source with the probes in the wide kernel's lane code (the
    device function ``round4_wide_lane`` where the source has one, else the
    kernel); the end before its final write of N, the tested and accepted
    candidates counted at the test and accept marks."""
    body = "round4_wide_lane" if "round4_wide_lane(" in src else "rbf_round4_wide_kernel"
    return _clock_probe.instrument(
        src, body, tuple(a for a, _ in _ANCHORS),
        end=r"^(?!.*return).*N_out\[b\] = N;\s*$", include='#include "rbf_phi.cuh"',
        name="round4", leader="threadIdx.x == 0", slot="blockIdx.x", slots=_SLOTS,
        counted=(PHASES.index("test"), PHASES.index("accept")), required=3)


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

    src = prepare_fused.ROUND4_SOURCE
    lib = _clock_probe.build(instrument(src.read_text()), "round4", cuda_build,
                             prepare_fused._SIGNATURES[src],
                             (*cuda_build.NO_FMA, "-I", str(cuda_build.CSRC)))
    rows = []
    for dtype in (torch.float32, torch.float64):
        # the library's cache key: the source, or (source, dtype) where a
        # checkout builds K3 per dtype (its float64 build links a pow, which
        # the probe's build inlines: see same_as_unprobed)
        key = ((src, dtype) if dtype == torch.float64
               and hasattr(prepare_fused, "ROUND4_F64_FLAGS") else src)
        sets = (load_round4(inputs, dtype) if inputs else []) + [random_wide(dtype)]
        for name, args, kw in sets:
            B = args[0].shape[0]
            acc, N = prepare_fused.round4_cuda(*args, **kw)
            built = prepare_fused._libs[key]
            ms = cs.event_ms(lambda: prepare_fused.round4_cuda(*args, **kw), 5)
            prof = torch.zeros((B, _SLOTS), dtype=torch.int64, device="cuda")
            _clock_probe.attach(lib, "round4", prof)
            prepare_fused._libs[key] = lib
            acc_p, N_p = prepare_fused.round4_cuda(*args, **kw)
            probed_ms = cs.event_ms(lambda: prepare_fused.round4_cuda(*args, **kw), 3)
            prepare_fused._libs[key] = built
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
