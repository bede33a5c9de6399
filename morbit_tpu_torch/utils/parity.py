"""Trajectory interchange format.

Counterpart of ``export_trajectory`` in ``morbit_tpu/utils/parity.py``: one
run as ``{"iterates": [...], "delta": [...],
"it_stat": ["INITIALIZATION", ...], "n_evals": N}``, the format of the
golden files ``tests/golden/*.json`` and of the JAX package's comparator
``compare_trajectories``.
"""

from __future__ import annotations

import json
from typing import Optional

from morbit_tpu_torch.core.enums import ITER_TYPE
from morbit_tpu_torch.utils.logging import trajectory_arrays


def export_trajectory(result, path: Optional[str] = None) -> dict:
    """Dump one ``optimize`` run in the interchange format."""
    tr = trajectory_arrays(result)
    doc = {
        "iterates": tr["x"].tolist(),
        "delta": tr["delta"].tolist(),
        "it_stat": [ITER_TYPE(int(s)).name for s in tr["it_stat"]],
        "n_evals": int(result.n_evals),
    }
    if path:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc
