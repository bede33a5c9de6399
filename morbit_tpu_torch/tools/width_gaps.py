"""How far a float64 run on the card moves with the width of its batch.

The problem of ``tests/test_torch_cuda.py::test_mesh_on_card_matches_unsharded``:
the two parabolas on [-4, 4]^2 in one multiquadric RBF group, 16 Halton
starts, ``max_iter=12, qp_iters=100``, float64. Three parts, one JSON line
each:

* ``runs``: each run below against the plain runner's unsharded batch of
  16, leaf by leaf after ``canonicalize_buffer_tails``: whether every
  integer leaf is equal, and each float leaf's largest absolute gap, the
  trajectory split into its columns (x, fx, delta, rho, omega,
  steplength, and the rest: iteration kinds, indices, model data). The
  runs: ``StagedMultistart(schedule=(3, 6), widths=(16, 8, 8))``
  unsharded and with the mesh ``[cuda:0] * 4`` (stages 4, 2 and 2 lanes
  wide in each shard), and the plain runner with the meshes
  ``[cuda:0] * k`` for k in 2, 4, 8, 16 (shards of 8, 4, 2 and 1 lanes);
* ``lockstep``: trip by trip from one state, the plain runner's trip at
  width 16 against the same trip of its shards of 2 lanes; the
  first trips at which some leaf differs at all, with the leaf, the lane
  and both values;
* ``products``: the float64 library calls of the port's solves (``a @
  b``, ``torch.linalg.solve_ex``, ``lu_factor_ex`` + ``lu_solve``,
  ``cholesky_ex`` + ``cholesky_solve``) on random inputs of shape (16, k,
  k) and (16, k, m): the (k, m, w) for which the first w lanes' results in
  a batch of w are not equal to the bit to theirs in the batch of 16.

    python3 -m morbit_tpu_torch.tools.width_gaps [--device cuda|cpu] [--parts runs lockstep products]

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

LB, UB = [-4.0, -4.0], [4.0, 4.0]
B = 16
#: the shard width of the lockstep
NARROW = 2
TRAJ_COLS = ("delta", "rho", "omega", "steplength")


def _mop():
    from morbit_tpu_torch.models.configs import RbfConfig
    from morbit_tpu_torch.problems.synthetic import make_two_parabolas

    return make_two_parabolas(RbfConfig(kernel="multiquadric"), LB, UB)


def leaf_gaps(a: dict, b: dict, n: int, m: int) -> tuple:
    """Whether the integer leaves of two ``state_to_numpy`` dicts are
    equal, and each float leaf's largest absolute gap (the trajectory by
    column)."""
    ints_equal, gaps = True, {}
    for name in a:
        x, y = a[name], b[name]
        if x.dtype.kind in "biu":
            ints_equal &= bool(np.array_equal(x, y))
            continue
        if name == "traj.data":
            cols = {"traj.x": slice(0, n), "traj.fx": slice(n, n + m)}
            cols.update({f"traj.{c}": slice(n + m + j, n + m + j + 1)
                         for j, c in enumerate(TRAJ_COLS)})
            cols["traj.rest"] = slice(n + m + len(TRAJ_COLS), None)
            for c, sl in cols.items():
                gaps[c] = _gap(x[..., sl], y[..., sl])
        else:
            gaps[name] = _gap(x, y)
    return ints_equal, gaps


def _gap(x, y) -> float:
    both = np.isfinite(x) & np.isfinite(y)
    if (np.isfinite(x) != np.isfinite(y)).any():
        return float("inf")
    return float(np.abs(np.where(both, x, 0.0) - np.where(both, y, 0.0)).max(initial=0.0))


def runs(x0, ac, dev: str) -> dict:
    from morbit_tpu_torch import StagedMultistart, multistart_optimize
    from morbit_tpu_torch.parallel.multistart import canonicalize_buffer_tails
    from morbit_tpu_torch.utils.carry import state_to_numpy

    leaves = lambda r: state_to_numpy(canonicalize_buffer_tails(r.state))
    ref = leaves(multistart_optimize(_mop(), x0, ac, torch.float64, device=dev))
    staged = lambda mesh: StagedMultistart(_mop(), ac, torch.float64, schedule=(3, 6),
                                           widths=(16, 8, 8), mesh=mesh, device=dev)(x0)
    todo = {"staged_widths": lambda: staged(None),
            "staged_widths_mesh4": lambda: staged([dev] * 4)}
    for k in (2, 4, 8, 16):
        todo[f"plain_mesh{k}"] = lambda k=k: multistart_optimize(
            _mop(), x0, ac, torch.float64, mesh=[dev] * k)
    out = {}
    for name, run in todo.items():
        ints_equal, gaps = leaf_gaps(leaves(run()), ref, 2, 2)
        out[name] = {"integers_equal": ints_equal,
                     "largest_gap": max(gaps.values()),
                     "gaps": {k: v for k, v in gaps.items() if v > 0}}
    return out


def lockstep(x0, ac, dev: str) -> list:
    from morbit_tpu_torch import STOP_CODE
    from morbit_tpu_torch.parallel.multistart import build_solver
    from morbit_tpu_torch.utils.carry import state_to_numpy
    from morbit_tpu_torch.utils.tree import tree_map, tree_where

    solver = build_solver(_mop(), ac, torch.float64, dev)
    state = solver.initialize(x0)
    found, trip = [], 0
    while len(found) < 3:
        running = state.stop_code == STOP_CODE.CONTINUE
        if not bool(running.any()):
            break
        wide = tree_where(running, solver.iterate(state), state)
        parts = []
        for lo in range(0, B, NARROW):
            sub = tree_map(lambda t: t[lo:lo + NARROW], state)
            run = sub.stop_code == STOP_CODE.CONTINUE
            parts.append(tree_where(run, solver.iterate(sub), sub))
        narrow = tree_map(lambda *ts: torch.cat(ts, 0), *parts)
        a, b = state_to_numpy(wide), state_to_numpy(narrow)
        trip += 1
        diffs = []
        for name in a:
            same = a[name] == b[name]
            if a[name].dtype.kind == "f":
                same |= np.isnan(a[name]) & np.isnan(b[name])
            bad = np.argwhere(~same)
            if len(bad):
                at = tuple(bad[0])
                diffs.append({"leaf": name, "entries": len(bad), "first": list(map(int, at)),
                              "wide": float(a[name][at]), "narrow": float(b[name][at])})
        if diffs:
            found.append({"trip": trip, "diffs": diffs})
        state = wide
    return found


def _ops():
    """The float64 library calls of the port's solves, each on (A, b)."""
    def lu(A, b):
        LU, piv, _ = torch.linalg.lu_factor_ex(A)
        return torch.linalg.lu_solve(LU, piv, b)

    def chol(A, b):
        L, _ = torch.linalg.cholesky_ex(A @ A.transpose(-1, -2))
        return torch.cholesky_solve(b, L)

    return {"matmul": lambda A, b: A @ b,
            "solve_ex": lambda A, b: torch.linalg.solve_ex(A, b)[0],
            "lu_factor_solve": lu, "cholesky_solve": chol}


def products(dev: str) -> dict:
    """For each library call, the (k, m, w) at which the first w lanes'
    results of a batch of w differ from theirs in the batch of 16."""
    g = torch.Generator(device=dev).manual_seed(0)
    apart = {name: [] for name in _ops()}
    for k in (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 77, 128):
        for m in (1, 2):
            A = torch.randn(B, k, k, dtype=torch.float64, device=dev, generator=g)
            b = torch.randn(B, k, m, dtype=torch.float64, device=dev, generator=g)
            for name, op in _ops().items():
                full = op(A, b)
                for w in (1, 2, 3, 4, 8):
                    if not torch.equal(full[:w], op(A[:w], b[:w])):
                        apart[name].append([k, m, w])
    return apart


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--parts", nargs="*", default=["runs", "lockstep", "products"])
    args = p.parse_args(argv)
    dev = args.device
    from morbit_tpu_torch import AlgorithmConfig
    from morbit_tpu_torch.problems.synthetic import halton_starts

    ac = AlgorithmConfig(max_iter=12, qp_iters=100)
    x0 = torch.as_tensor(halton_starts(B, LB, UB), dtype=torch.float64, device=dev)
    card = torch.cuda.get_device_name(0) if dev == "cuda" else dev
    if "runs" in args.parts:
        print(json.dumps({"part": "runs", "card": card, "runs": runs(x0, ac, dev)}),
              flush=True)
    if "lockstep" in args.parts:
        print(json.dumps({"part": "lockstep", "card": card, "width": NARROW,
                          "first_trips_apart": lockstep(x0, ac, dev)}),
              flush=True)
    if "products" in args.parts:
        print(json.dumps({"part": "products", "card": card,
                          "k_m_w_apart_from_width_16": products(dev)}), flush=True)


if __name__ == "__main__":
    main()
