"""The states around each lane's first non-finite RBF fit in one grid setting.

Steps the plain runner's batch of the float32 grid setting
``zdt2-n10-rbf_cubic-steepest_descent-s8`` (``parallel/benchmarks.py``:
``make_problem``, ``_default_config``, the 8 Halton starts, or those of
``--lanes``) trip by trip as ``Solver.solve_from_state`` does, lanes frozen
once they stop. For every lane whose RBF coefficients first turn
non-finite at some trip, it saves the lane's state before that trip and
after it, as ``utils/carry.state_to_numpy`` leaves with a lane axis of 1,
under ``"lane<i>/before/<leaf>"`` and ``"lane<i>/after/<leaf>"``. The
batch's final integers are held against ``multistart_optimize``'s run of
the setting, so the trips are the runner's. Prints one JSON line: the
lanes, the trip of each first non-finite fit, and the final stop codes,
iterations and evaluations::

    python3 -m morbit_tpu_torch.tools.nan_fit_states [--device cuda|cpu] [--lanes I ...] [--out PATH]

``--out`` defaults to ``build/nan_fit_states_<device>.npz``.
``tests/torch_record_zdt2_f32.py --port-states`` records the JAX package's
trip from each saved ``before`` state.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

SETTING = ("zdt2", 10, "rbf_cubic", "steepest_descent", 8)


def fit_non_finite(state) -> np.ndarray:
    """(B,) bool: lanes whose RBF coefficients (of any group) are not
    finite."""
    bad = torch.zeros(state.x.shape[0], dtype=torch.bool, device=state.x.device)
    for g in state.groups:
        fit = getattr(g.model, "fit", None)
        if fit is not None:
            bad |= ~(torch.isfinite(fit.w).flatten(1).all(-1)
                     & torch.isfinite(fit.lam).flatten(1).all(-1))
    return bad.cpu().numpy()


def capture(device: str, lanes=None) -> tuple:
    """The saved leaves and the JSON summary of one run on ``device`` of
    the Halton starts ``lanes`` (default all), named by their start."""
    from morbit_tpu_torch import STOP_CODE, multistart_optimize
    from morbit_tpu_torch.parallel.benchmarks import Setting, _default_config, make_problem
    from morbit_tpu_torch.parallel.multistart import build_solver
    from morbit_tpu_torch.problems.synthetic import halton_starts
    from morbit_tpu_torch.utils.carry import state_to_numpy
    from morbit_tpu_torch.utils.tree import tree_where

    s = Setting(*SETTING)
    mop = make_problem(s.problem, s.n_vars, s.model)
    ac = _default_config(s)
    starts = list(range(s.n_starts)) if lanes is None else list(lanes)
    x0 = torch.as_tensor(halton_starts(s.n_starts, mop.lb, mop.ub)[starts],
                         dtype=torch.float32, device=device)
    solver = build_solver(mop, ac, torch.float32, device)
    state = solver.initialize(x0)
    seen = fit_non_finite(state)
    out, first, trip = {}, {}, 0
    while True:
        running = state.stop_code == STOP_CODE.CONTINUE
        if not bool(running.any()):
            break
        before = state_to_numpy(state)
        state = tree_where(running, solver.iterate(state), state)
        trip += 1
        new = fit_non_finite(state) & ~seen
        seen |= new
        if new.any():
            after = state_to_numpy(state)
            for i in np.nonzero(new)[0].tolist():
                first[starts[i]] = trip
                for tag, leaves in (("before", before), ("after", after)):
                    for k, v in leaves.items():
                        out[f"lane{starts[i]}/{tag}/{k}"] = v[i:i + 1]
    ref = multistart_optimize(mop, x0, ac, torch.float32, device=device)
    ints = {"stop_code": state.stop_code, "n_iterations": state.iter_counter - 1,
            "n_evals": solver._total_evals(state.groups)}
    for k, v in ints.items():
        if not torch.equal(v, getattr(ref, k)):
            raise AssertionError(f"the trips' {k} differ from multistart_optimize's")
    summary = {"setting": s.key,
               "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
               "starts": starts, "trips": trip, "first_non_finite_fit_trip": first,
               **{k: v.tolist() for k, v in ints.items()}}
    return out, summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--lanes", type=int, nargs="*", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    path = args.out or os.path.join("build", f"nan_fit_states_{args.device}.npz")
    out, summary = capture(args.device, args.lanes)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **out)
    print(json.dumps({**summary, "saved": path}))


if __name__ == "__main__":
    main()
