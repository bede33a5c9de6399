"""Host-side views of a finished run.

Counterpart of ``trajectory_arrays`` in ``morbit_tpu/utils/logging.py``.
"""

from __future__ import annotations

import numpy as np


def trajectory_arrays(result, lane: int | None = None):
    """Trimmed (count,) trajectory arrays — the analogue of reading
    ``db.iter_data`` (``examples/example_two_parabolas.jl:76``). ``lane``
    selects one run of a batched result; a single optimize() result needs
    none."""
    traj = result.state.traj
    view = (lambda t: t) if lane is None else (lambda t: t[lane])
    c = int(view(traj.count))
    host = lambda t: np.asarray(view(t).detach().cpu())[:c]
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
