"""Host-side views of a run: the live in-loop log, the trajectory arrays,
the final report and the per-function evaluation counts.

Counterpart of ``morbit_tpu/utils/logging.py``. The reference prints
per-iteration banners and a final report through its custom log levels
(``src/custom_logging.jl:18-66``, ``algorithm.jl:651-659``, ``:890-897``,
``_fin_info_str`` ``:114-129``); here every iteration stamps its record
into the trajectory buffer and :func:`print_report` renders it after the
run, with the JAX package's text. Each function takes an ``optimize``
result, or one lane of a batched result with ``lane``. :class:`LiveLog`
prints the JAX package's live lines of ``verbosity >= 3`` while the run
goes.
"""

from __future__ import annotations

import numpy as np
import torch

from morbit_tpu_torch.core.enums import ITER_TYPE, STOP_CODE


class LiveLog:
    """The live in-loop log of lane 0 (``Solver(log_level=)``, the JAX
    package's ``jax.debug.print`` sites, ``morbit_tpu/core/algorithm.py``
    and ``models/container.py:244-252``).

    Each site adds a line: its level, JAX's format string, the lanes on
    which JAX's single run would reach the site (``when``, a (B,) bool
    tensor or None for always), and the values it prints (tensors with the
    lane axis first, or Python values). Nothing leaves the device until
    :meth:`flush`, which brings the trip's lane-0 values to the host in one
    transfer and prints the lines whose conditions hold, in order, with
    JAX's text: the values as numpy arrays of their own dtype, formatted by
    ``str.format`` as ``jax.debug.print`` does."""

    def __init__(self, level: int, out=print):
        self.level = int(level)
        self.out = out
        self._lines = []

    def add(self, level: int, fmt: str, when=None, at=None, **values) -> None:
        """Add a line if the log's level reaches ``level``; ``at`` inserts it
        before the line of that index (:meth:`mark`) instead of last."""
        if self.level >= level:
            line = (fmt, when, values)
            self._lines.insert(len(self._lines) if at is None else at, line)

    def mark(self) -> int:
        """The index the next line will take."""
        return len(self._lines)

    def flush(self, when=None) -> None:
        """Print the lines added since the last flush whose conditions (and
        ``when``, the trip's own) hold at lane 0."""
        lines, self._lines = self._lines, []
        if not lines:
            return
        parts, specs = [], []

        def put(v):
            if not isinstance(v, torch.Tensor):
                return ("py", v)
            v = v[0] if v.dim() else v
            parts.append(v.detach().reshape(-1).to(torch.float64))
            return ("t", v.dtype, tuple(v.shape), len(parts) - 1)

        gate = None if when is None else put(when)
        staged = [(fmt, None if w is None else put(w), {k: put(v) for k, v in vals.items()})
                  for fmt, w, vals in lines]
        if not parts:
            host = []
        else:
            flat = torch.cat(parts).cpu().numpy()   # the trip's one transfer
            sizes = np.cumsum([0] + [p.numel() for p in parts])
            host = [flat[a:b] for a, b in zip(sizes[:-1], sizes[1:])]

        def get(spec):
            if spec[0] == "py":
                return spec[1]
            _, dtype, shape, i = spec
            return host[i].astype(str(dtype).removeprefix("torch.")).reshape(shape)

        if gate is not None and not bool(get(gate)):
            return
        for fmt, w, vals in staged:
            if w is None or bool(get(w)):
                self.out(fmt.format(**{k: get(v) for k, v in vals.items()}))


def _host(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _lane_view(lane):
    """A leaf, or its lane ``lane``, as a numpy array on the host."""
    return (lambda t: _host(t)) if lane is None else (lambda t: _host(t[lane]))


def trajectory_arrays(result, lane: int | None = None):
    """Trimmed (count,) trajectory arrays — the analogue of reading
    ``db.iter_data`` (``examples/example_two_parabolas.jl:76``). ``lane``
    selects one run of a batched result; a single optimize() result needs
    none."""
    traj = result.state.traj
    view = _lane_view(lane)
    c = int(view(traj.count))
    host = lambda t: view(t)[:c]
    return {
        "x": host(traj.x),
        "fx": host(traj.fx),
        "delta": host(traj.delta),
        "rho": host(traj.rho),
        "omega": host(traj.omega),
        "steplength": host(traj.steplength),
        "it_stat": host(traj.it_stat),
        # per-group database row of each stamped iterate
        # (``IterDataIterSaveable.jl:189-205``)
        "x_indices": host(traj.x_indices),
    }


def _fmt_vec(v, n=5):
    v = np.asarray(v).ravel()
    body = ", ".join(f"{x:.5f}" for x in v[:n])
    return "[" + body + (", …" if v.size > n else "") + "]"


def print_report(result, verbosity: int = 1, out=print, lane: int | None = None):
    """The final report, with a line per stamped iteration at
    ``verbosity >= 2``."""
    view = _lane_view(lane)
    if verbosity >= 2:
        tr = trajectory_arrays(result, lane)
        for i in range(tr["it_stat"].shape[0]):
            stat = ITER_TYPE(int(tr["it_stat"][i])).name
            out(f"| iter {i:3d}  {stat:<14s} x={_fmt_vec(tr['x'][i])} "
                f"Δ={float(tr['delta'][i]):.3e} ω={float(tr['omega'][i]):.3e} "
                f"ρ={float(tr['rho'][i]):.3e} "
                f"‖s‖={float(tr['steplength'][i]):.3e}")
    code = STOP_CODE(int(view(result.stop_code))).name
    out("|--------------------------------------------")
    out(f"| FINISHED ({code})")
    out("|--------------------------------------------")
    out(f"| Stopped in iteration:  {int(view(result.n_iterations))}")
    out(f"| No. evaluations: {int(view(result.n_evals))}")
    out("| final unscaled vectors:")
    out(f"| iterate: {_fmt_vec(view(result.x), 10)}")
    out(f"| value:   {_fmt_vec(view(result.fx), 10)}")
    for line in overflow_warnings(result.state, lane):
        out(f"| WARNING: {line}")


def overflow_warnings(state, lane: int | None = None):
    """Capacity-overflow warnings for a solver state (empty if none). The
    reference's database and filter are unbounded; the port's
    fixed-capacity buffers raise sticky overflow flags instead of dropping
    writes silently."""
    view = _lane_view(lane)
    lines = []
    for gi, g in enumerate(state.groups):
        if bool(np.any(view(g.db.overflow))):
            lines.append(
                f"group {gi} database overflowed its capacity "
                f"({g.db.data.shape[-2]} rows): model training sets are "
                "missing dropped points — raise db_capacity / use the "
                "auto heuristic")
    if bool(np.any(view(state.filter.overflow))):
        lines.append(
            f"filter overflowed its capacity "
            f"({state.filter.theta.shape[-1]} rows): acceptability tests "
            "are weaker than the reference's unbounded filter — raise "
            "filter_capacity / use the auto (max_iter + 2) default")
    return lines


def function_eval_counts(result, cmop, lane: int | None = None):
    """True-evaluation counts per function (the ``CountedFunc`` view,
    ``src/globals.jl:74-112``): each member function reports its group's
    counter (one vector call evaluates every member), duplicate
    registrations the shared one. A list indexed like ``mop.functions``."""
    view = _lane_view(lane)
    groups = result.state.groups if hasattr(result, "state") else result
    counts = {}
    for g in cmop.groups:
        n = int(view(groups[g.index].n_evals))
        for mb in g.members:
            counts[mb.fn_index] = n
    n_fns = max(counts, default=-1) + 1
    return [counts.get(i, 0) for i in range(n_fns)]
