"""Multistart convergence quality at the bench config (the port's gauge).

Counterpart of ``tools/check_convergence.py``: two parabolas in 2D, both
objectives in one multiquadric RBF group, 1024 Halton starts from index 1,
run by the plain batched runner (``multistart_optimize``). The Pareto set
is the segment x1 = x2 in [-1, 1]; prints one JSON line with the fraction of
runs whose final iterate lies within ``TOL`` of it (``d < TOL``, the
reference's test) and the median distance.

    python3 -m morbit_tpu_torch.tools.check_convergence [max_iter] [qp_iters]
        [--device cuda|cpu] [--dtype f32|f64] [--plain qp_admm,rbf_selection,rbf_round4]
        [--cpu-ops polish,linalg,rbf,descent]

Runs on CUDA unless ``--device cpu`` is given. ``--plain`` runs the named
kernels' plain twins in place of the kernels on the card, and ``--cpu-ops``
runs the named groups of plain PyTorch operations on the CPU within a card
run (``CPU_GROUPS``), to tell which computation a difference between the
card and the CPU follows.
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


#: plain operation groups that ``--cpu-ops`` runs on the CPU: group name ->
#: (module, function) pairs patched where the solver calls them
CPU_GROUPS = {
    # the QP polish with its active set and KKT solve (ops/qp.py)
    "polish": (("morbit_tpu_torch.ops.qp", "_polish"),),
    # the unrolled Gauss-Jordan inverse of the polish and solve_small of the
    # RBF fit (ops/batched_linalg.py)
    "linalg": (("morbit_tpu_torch.ops.qp", "gj_inverse"),
               ("morbit_tpu_torch.ops.rbf", "solve_small")),
    # the RBF fit's dense algebra, its evaluation and Jacobian (ops/rbf.py)
    "rbf": (("morbit_tpu_torch.models.rbf_model", "fit_rbf"),
            ("morbit_tpu_torch.models.rbf_model", "eval_rbf"),
            ("morbit_tpu_torch.models.rbf_model", "rbf_jacobian")),
    # the descent LP's row norms, the initial stepsize and the backtracking's
    # ladder, tests and picks (core/descent.py; model values stay on the card)
    "descent": (("morbit_tpu_torch.core.descent", "descent_lp"),
                ("morbit_tpu_torch.core.algorithm", "initial_stepsize"),
                ("morbit_tpu_torch.core.algorithm", "backtrack")),
}


def _moved(tree, device):
    from morbit_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.to(device), tree)


def on_cpu(fn):
    """``fn`` with its tensor arguments moved to the CPU and its tensor
    results moved back to the device of its first tensor argument."""
    def wrapped(*args, **kw):
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        out = fn(*_moved(args, "cpu"), **{k: _moved(v, "cpu") for k, v in kw.items()})
        return _moved(out, dev)
    return wrapped


def backtrack_on_cpu(fn):
    """``backtrack`` with its ladder arithmetic, Armijo tests and picks on
    the CPU; the model evaluations it calls back stay on the card."""
    def wrapped(x_n, d, sigma0, omega, eval_mx, states, cfg, eval_mx_batch):
        dev = x_n.device

        def mx(st, x):
            v, st = eval_mx(st, x.to(dev))
            return v.cpu(), st

        def mx_batch(st, X, k_used):
            v, st = eval_mx_batch(st, None if X is None else X.to(dev),
                                  None if k_used is None else k_used.to(dev))
            return (None if v is None else v.cpu()), st

        x_t, mx_t, step, states = fn(*_moved((x_n, d, sigma0, omega), "cpu"), mx,
                                     states, cfg, mx_batch)
        return x_t.to(dev), mx_t.to(dev), step.to(dev), states
    return wrapped


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
    args.add_argument("--cpu-ops", default="")
    a = args.parse_args(argv)
    plain = [k for k in a.plain.split(",") if k]
    cpu_ops = [k for k in a.cpu_ops.split(",") if k]
    for given, known, flag in ((plain, TWINS, "--plain"), (cpu_ops, CPU_GROUPS, "--cpu-ops")):
        for k in given:
            if k not in known:
                raise SystemExit(f"{flag} takes {', '.join(known)}, got {k!r}")
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
        for mod, name in (pair for g in cpu_ops for pair in CPU_GROUPS[g]):
            mod = importlib.import_module(mod)
            wrap = backtrack_on_cpu if name == "backtrack" else on_cpu
            stack.enter_context(mock.patch.object(mod, name, wrap(getattr(mod, name))))
        res = multistart_optimize(rbf_main_mop(), halton_starts(BATCH, LB, UB), ac,
                                  dtype=dtype, device=device)
    seconds = time.perf_counter() - t0
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    print(json.dumps({"device": kind, "dtype": a.dtype, "plain": plain,
                      "cpu_ops": cpu_ops, "max_iter": a.max_iter,
                      "qp_iters": a.qp_iters, "tol": TOL, **convergence(res.x),
                      "trips": res.trips, "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
