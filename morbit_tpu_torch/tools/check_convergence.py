"""Multistart convergence quality at the bench config (the port's gauge).

Counterpart of ``tools/check_convergence.py``: two parabolas in 2D, both
objectives in one multiquadric RBF group, 1024 Halton starts from index 1,
run by the plain batched runner (``multistart_optimize``). The Pareto set
is the segment x1 = x2 in [-1, 1]; prints one JSON line with the fraction of
runs whose final iterate lies within ``TOL`` of it (``d < TOL``, the
reference's test) and the median distance.

    python3 -m morbit_tpu_torch.tools.check_convergence [max_iter] [qp_iters]
        [--device cuda|cpu] [--dtype f32|f64] [--plain qp_admm,rbf_selection,rbf_round4]

Runs on CUDA unless ``--device cpu`` is given. ``--plain`` runs the named
kernels' plain twins in place of the kernels on the card, to tell which
computation a difference between the card and the CPU follows.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from unittest import mock

import numpy as np
import torch

TOL = 1e-2
BATCH = 1024
LB, UB = [-4.0, -4.0], [4.0, 4.0]
#: kernel name -> (module, its routing wrapper, the plain twin it holds)
TWINS = {"qp_admm": ("morbit_tpu_torch.ops.qp_lane", "admm_stages", "admm_stages_plain"),
         "rbf_selection": ("morbit_tpu_torch.ops.prepare_fused", "selection",
                           "rbf_selection_core"),
         "rbf_round4": ("morbit_tpu_torch.ops.prepare_fused", "round4", "run_round4")}


def pareto_distance(x) -> np.ndarray:
    """Distance of each row of ``x`` (B, 2) to the segment {(t, t) : t in
    [-1, 1]}."""
    x = np.asarray(torch.as_tensor(x).detach().cpu().double())
    t = np.clip((x[:, 0] + x[:, 1]) / 2.0, -1.0, 1.0)
    return np.linalg.norm(x - t[:, None], axis=1)


def convergence(x, tol: float = TOL) -> dict:
    """The gauge's two figures for final iterates ``x`` (B, 2): the share
    within ``tol`` of the Pareto set (strictly, as the reference counts)
    and the median distance."""
    d = pareto_distance(x)
    return {"convergence": float(np.mean(d < tol)), "within": int(np.sum(d < tol)),
            "median_dist": float(np.median(d))}


def rbf_main_mop():
    from morbit_tpu_torch.models.configs import RbfConfig
    from morbit_tpu_torch.problems.synthetic import make_two_parabolas

    return make_two_parabolas(RbfConfig(kernel="multiquadric"), LB, UB)


def main(argv=None) -> int:
    args = argparse.ArgumentParser()
    args.add_argument("max_iter", nargs="?", type=int, default=10)
    args.add_argument("qp_iters", nargs="?", type=int, default=100)
    args.add_argument("--device", default=None)
    args.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    args.add_argument("--plain", default="")
    a = args.parse_args(argv)
    plain = [k for k in a.plain.split(",") if k]
    for k in plain:
        if k not in TWINS:
            raise SystemExit(f"--plain takes {', '.join(TWINS)}, got {k!r}")
    from morbit_tpu_torch import AlgorithmConfig, multistart_optimize
    from morbit_tpu_torch.core.algorithm import resolve_device
    from morbit_tpu_torch.problems.synthetic import halton_starts

    device = resolve_device(a.device)
    dtype = torch.float64 if a.dtype == "f64" else torch.float32
    ac = AlgorithmConfig(max_iter=a.max_iter, qp_iters=a.qp_iters)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for k in plain:
            mod, wrapper, twin = TWINS[k]
            mod = importlib.import_module(mod)
            stack.enter_context(mock.patch.object(mod, wrapper, getattr(mod, twin)))
        res = multistart_optimize(rbf_main_mop(), halton_starts(BATCH, LB, UB), ac,
                                  dtype=dtype, device=device)
    seconds = time.perf_counter() - t0
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    print(json.dumps({"device": kind, "dtype": a.dtype, "plain": plain, "max_iter": a.max_iter,
                      "qp_iters": a.qp_iters, "tol": TOL, **convergence(res.x),
                      "trips": res.trips, "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
