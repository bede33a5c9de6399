"""Solver-state checkpointing (save and resume).

Counterpart of ``morbit_tpu/utils/checkpoint.py``. The reference's
checkpoint/resume story is database recycling (``populated_db``) plus
saves of benchmark partials; here the whole batched ``SolverState`` is a
tree of tensors, so a checkpoint is a flat ``.npz`` file of its leaves in
tree order.
"""

from __future__ import annotations

import numpy as np
import torch

from morbit_tpu_torch.utils.tree import tree_map


def tree_leaves(tree) -> list:
    """The tensor leaves of a state tree, in :func:`tree_map`'s order."""
    leaves = []
    tree_map(lambda t: leaves.append(t) or t, tree)
    return leaves


def save_state(path: str, state) -> None:
    """Save any solver-state tree to ``path`` (.npz)."""
    np.savez(path, **{f"leaf_{i}": t.detach().cpu().numpy()
                      for i, t in enumerate(tree_leaves(state))})


def load_state(path: str, template):
    """Load a tree saved by :func:`save_state`. ``template`` gives the
    structure, the static fields and each leaf's dtype and device (for
    example a freshly initialized state of the same solver); the shapes
    are the file's."""
    data = np.load(path)
    n = len(tree_leaves(template))
    if len(data.files) != n:
        raise ValueError(f"{path} holds {len(data.files)} leaves, the template {n}")
    it = iter(range(n))
    return tree_map(lambda t: torch.as_tensor(data[f"leaf_{next(it)}"], dtype=t.dtype,
                                              device=t.device), template)
