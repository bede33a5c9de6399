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
* ``ops`` (not run by default): within the trip after each of
  ``--trips``, every torch call's output lanes at width 16 against the
  same call in the shards of 2 (``--narrow``) lanes (``op_trace``), and each call, by the
  line of the package that made it, whose lanes differ although its
  inputs are equal to the bit;
* ``products``: the library calls of the port's solves on the card
  (``torch.linalg.solve_ex`` at the fits' sizes, ``lu_factor_ex`` +
  ``lu_solve`` at the polish's, ``a @ b`` with 1-3 columns; float64 and
  float32, where the float32 products are ``lane_matmul``'s float64 sums,
  ``lane_matmul_sum``)
  and the float64 kernels that replace them (K6 ``lane_lu``, K7
  ``lane_matmul``), and a lane's ``sum`` over k values, on random inputs of shape (16, k, k) and (16, k, m):
  the (k, m, w) for which the first w lanes' results in a batch of w are
  not equal to the bit to theirs in the batch of 16, w in 1, 2, 4, 8, and
  the first such value of each call.

    python3 -m morbit_tpu_torch.tools.width_gaps [--device cuda|cpu] [--parts runs lockstep ops products] [--problem parabolas|name,n,model] [--narrow W] [--trips T ...]

``--problem`` sets the lockstep's and the ops part's problem: a setting of
``parallel/benchmarks.py`` (``zdt1,10,rbf_cubic``: ZDT1 at n = 10 in one
cubic RBF group) with 16 Halton starts and the same budget.

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


def leaves_apart(a: dict, b: dict) -> list:
    """The leaves of two ``state_to_numpy`` dicts that are not equal to the
    bit (shape, dtype and bytes)."""
    return [name for name in a
            if a[name].shape != b[name].shape or a[name].dtype != b[name].dtype
            or a[name].tobytes() != b[name].tobytes()]


def width_invariance(dev: str) -> dict:
    """The float64 width check of ``chip_smoke.py`` (``width_invariance_f64``)
    and of the card test: the plain runner over the meshes ``[dev] * k``,
    k in 2, 4, 8, 16, and ``StagedMultistart(schedule=(3, 6), widths=(16, 8,
    8))`` over a mesh of 4, each against the unsharded plain batch of 16
    leaf by leaf after ``canonicalize_buffer_tails``: the leaves that are
    not equal to the bit, whether the integers are equal and the largest
    float gap."""
    from morbit_tpu_torch import AlgorithmConfig, StagedMultistart, multistart_optimize
    from morbit_tpu_torch.parallel.multistart import canonicalize_buffer_tails
    from morbit_tpu_torch.problems.synthetic import halton_starts
    from morbit_tpu_torch.utils.carry import state_to_numpy

    ac = AlgorithmConfig(max_iter=12, qp_iters=100)
    x0 = torch.as_tensor(halton_starts(B, LB, UB), dtype=torch.float64, device=dev)
    leaves = lambda r: state_to_numpy(canonicalize_buffer_tails(r.state))
    ref = leaves(multistart_optimize(_mop(), x0, ac, torch.float64, device=dev))
    todo = {f"plain_mesh{k}": lambda k=k: multistart_optimize(
        _mop(), x0, ac, torch.float64, mesh=[dev] * k) for k in (2, 4, 8, 16)}
    todo["staged_widths_mesh4"] = lambda: StagedMultistart(
        _mop(), ac, torch.float64, schedule=(3, 6), widths=(16, 8, 8), mesh=[dev] * 4)(x0)
    out = {}
    for name, run in todo.items():
        got = leaves(run())
        ints_equal, gaps = leaf_gaps(got, ref, 2, 2)
        out[name] = {"leaves_apart": leaves_apart(got, ref), "integers_equal": ints_equal,
                     "largest_gap": max(gaps.values())}
    return out


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


def lockstep(make_mop, x0, ac, dev: str, narrow: int = NARROW) -> list:
    from morbit_tpu_torch import STOP_CODE
    from morbit_tpu_torch.parallel.multistart import build_solver
    from morbit_tpu_torch.utils.carry import state_to_numpy
    from morbit_tpu_torch.utils.tree import tree_map, tree_where

    solver = build_solver(make_mop(), ac, torch.float64, dev)
    state = solver.initialize(x0)
    found, trip = [], 0
    while len(found) < 3:
        running = state.stop_code == STOP_CODE.CONTINUE
        if not bool(running.any()):
            break
        wide = tree_where(running, solver.iterate(state), state)
        parts = []
        for lo in range(0, B, narrow):
            sub = tree_map(lambda t: t[lo:lo + narrow], state)
            run = sub.stop_code == STOP_CODE.CONTINUE
            parts.append(tree_where(run, solver.iterate(sub), sub))
        sharded = tree_map(lambda *ts: torch.cat(ts, 0), *parts)
        a, b = state_to_numpy(wide), state_to_numpy(sharded)
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


def ops_apart(make_mop, x0, ac, dev: str, trips: int, narrow: int = NARROW) -> dict:
    """Op by op within one trip: from the state after ``trips`` trips of the
    batch of B, that trip at width B and in shards of ``NARROW`` lanes
    (``op_trace``); every call (by its line) whose shard lanes part from the
    same lanes of the batch of B while its inputs are equal to the bit,
    with the first shard where it does and its relative gap."""
    from morbit_tpu_torch import STOP_CODE
    from morbit_tpu_torch.parallel.multistart import build_solver
    from morbit_tpu_torch.tools import op_trace
    from morbit_tpu_torch.utils.tree import tree_map, tree_where

    solver = build_solver(make_mop(), ac, torch.float64, dev)
    state = solver.initialize(x0)
    for _ in range(trips):
        running = state.stop_code == STOP_CODE.CONTINUE
        state = tree_where(running, solver.iterate(state), state)
    made, calls = {}, 0
    for lo in range(0, B, narrow):
        lanes = slice(lo, lo + narrow)
        sub = tree_map(lambda t: t[lanes], state)
        with op_trace.tracing(B, lanes) as on_wide:
            solver.iterate(state)
        with op_trace.tracing(narrow, slice(None)) as on_narrow:
            solver.iterate(sub)
        summary = op_trace.summarize(op_trace.compare(on_wide, on_narrow))
        calls = max(calls, summary["calls_compared"])
        for r in summary["gap_made_at"]:
            made.setdefault(f"{r['at']} {r['call']}", {"shard": lo, "rel_gap": r["out_gap"]})
    return {"trip": trips + 1, "calls_compared": calls, "gap_made_at": made}


#: the shapes of the port's float64 solves: the RBF fits' KKT size k (the
#: main path's 9 and 12, the n=10 path's 77, the n=20 path's 272, 600, the
#: n=50 path's 1,377) and the polish's K (nv + m: 9, 11, the n=20 path's 63
#: and the n=50 path's 153)
FIT_K = (9, 12, 77, 272, 600, 1377)
POLISH_K = (9, 11, 63, 153)
#: right-hand sides of a fit (one column an objective) and columns of a product
FIT_M = 2
PRODUCT_M = (1, 2, 3)
#: the lengths of the per-lane sums measured (the main path's 2-12, ZDT's
#: n = 20 and 50, the fits' k)
SUM_K = (12, 20, 50, 77, 272, 1377)
#: the narrower batches held against the batch of B
WIDTHS = (1, 2, 4, 8)


def _lu(A, b):
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    return torch.linalg.lu_solve(LU, piv, b)


def _k6(A, b):
    from morbit_tpu_torch.ops import lane_linalg

    LU, perm, _ = lane_linalg.lane_lu_factor_cuda(A)
    return lane_linalg.lane_lu_solve_cuda(LU, perm, b)


def _cases(dev):
    """(name, dtype, shapes, op): the library calls the port makes on the
    card and, at float64 on the card, the kernels that replace them (K6
    ``lane_lu``, K7 ``lane_matmul``). The shapes are (k, m) of a (B, k, k) matrix and a
    (B, k, m) right-hand side or factor."""
    from morbit_tpu_torch.ops import batched_linalg, lane_linalg

    fits = [(k, FIT_M) for k in FIT_K]
    polish = [(k, 1) for k in POLISH_K]
    prods = [(k, m) for k in sorted(set(FIT_K + POLISH_K)) for m in PRODUCT_M]
    f64_sum = lambda A, b: (A.double() @ b.double()).to(A.dtype)
    out = []
    for dt in (torch.float64, torch.float32):
        out += [("solve_ex", dt, fits, lambda A, b: torch.linalg.solve_ex(A, b)[0]),
                ("lu_factor_solve", dt, polish, _lu)]
    # a lane's sum over k values (one output a lane), PyTorch's reduction
    sums = [(k, 1) for k in SUM_K]
    out += [("sum", dt, sums, lambda A, b: A[:, 0].contiguous().sum(-1))
            for dt in (torch.float64, torch.float32)]
    out += [("matmul", torch.float64, prods, lambda A, b: A @ b),
            ("lane_matmul_sum", torch.float32, prods, f64_sum)]
    if dev != "cpu":
        out += [("lane_lu", torch.float64, fits + polish, _k6),
                ("lane_matmul", torch.float64, prods, lane_linalg.lane_matmul_cuda),
                ("lane_sum", torch.float64, sums,
                 lambda A, b: batched_linalg.lane_sum(A[:, 0].contiguous()))]
    return out


def products(dev: str) -> dict:
    """For each call, the (k, m, w) at which the first w lanes' results of
    a batch of w differ from theirs in the batch of B, and at each (k, m)
    the first differing value of the narrowest such w (both widths'
    values, lane and index)."""
    g = torch.Generator(device=dev).manual_seed(0)
    apart, first = {}, {}
    for name, dt, shapes, op in _cases(dev):
        key = f"{name}_{'f64' if dt == torch.float64 else 'f32'}"
        apart[key] = []
        for k, m in shapes:
            A = torch.randn(B, k, k, dtype=dt, device=dev, generator=g)
            b = torch.randn(B, k, m, dtype=dt, device=dev, generator=g)
            full = op(A, b)
            for w in WIDTHS:
                part = op(A[:w], b[:w])
                if torch.equal(full[:w], part):
                    continue
                apart[key].append([k, m, w])
                shape = f"k{k}_m{m}"
                if shape not in first.setdefault(key, {}):
                    at = tuple(int(i) for i in torch.nonzero(full[:w] != part)[0])
                    first[key][shape] = {"w": w, "at": list(at), "width_w": float(part[at]),
                                         f"width_{B}": float(full[at])}
    return {"k_m_w_apart": apart, "first_apart": first}


def _problem(spec: str):
    """The problem of ``--problem``: ``parabolas`` (this module's) or a
    setting of ``parallel/benchmarks.py`` as ``name,n,model``, with its
    Halton starts and the budget ``max_iter=12, qp_iters=100``."""
    from morbit_tpu_torch import AlgorithmConfig
    from morbit_tpu_torch.problems.synthetic import halton_starts

    if spec == "parabolas":
        make, lb, ub = _mop, LB, UB
    else:
        from morbit_tpu_torch.parallel.benchmarks import make_problem

        name, n, model = spec.split(",")
        make = lambda: make_problem(name, int(n), model)
        lb, ub = make().lb, make().ub
    return make, halton_starts(B, lb, ub), AlgorithmConfig(max_iter=12, qp_iters=100)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--parts", nargs="*", default=["runs", "lockstep", "products"])
    p.add_argument("--problem", default="parabolas",
                   help="for the lockstep and ops parts: parabolas or name,n,model")
    p.add_argument("--narrow", type=int, default=NARROW,
                   help="for the lockstep and ops parts: the shards' width")
    p.add_argument("--trips", type=int, nargs="*", default=[0],
                   help="for the ops part: the trips after which to compare op by op")
    args = p.parse_args(argv)
    dev = args.device
    make, starts, ac = _problem(args.problem)
    x0 = torch.as_tensor(starts, dtype=torch.float64, device=dev)
    card = torch.cuda.get_device_name(0) if dev == "cuda" else dev
    head = {"card": card, "problem": args.problem}
    if "runs" in args.parts:
        x_par = torch.as_tensor(_problem("parabolas")[1], dtype=torch.float64, device=dev)
        print(json.dumps({"part": "runs", "card": card, "runs": runs(x_par, ac, dev)}),
              flush=True)
    if "lockstep" in args.parts:
        print(json.dumps({"part": "lockstep", **head, "width": args.narrow,
                          "first_trips_apart": lockstep(make, x0, ac, dev, args.narrow)}),
              flush=True)
    if "ops" in args.parts:
        for t in args.trips:
            print(json.dumps({"part": "ops", **head, "width": args.narrow,
                              **ops_apart(make, x0, ac, dev, t, args.narrow)}), flush=True)
    if "products" in args.parts:
        print(json.dumps({"part": "products", "card": card, "of_width": B,
                          **products(dev)}), flush=True)


if __name__ == "__main__":
    main()
