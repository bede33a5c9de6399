"""Structure-preserving maps over the solver's state containers.

The state is built from frozen dataclasses, ``NamedTuple``s and tuples of
tensors, plus static Python metadata (ints, strings). :func:`tree_map`
applies a function to every tensor leaf and copies static fields from the
first tree — the role ``jax.tree_util.tree_map`` plays in the JAX package.
:func:`tree_where` is the per-lane select that replaces a vmapped
``lax.cond``: every leaf carries the lane axis first.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        kw = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, (torch.Tensor, tuple)) or dataclasses.is_dataclass(v):
                kw[f.name] = tree_map(fn, v, *(getattr(r, f.name) for r in rest))
        return dataclasses.replace(tree, **kw)
    if isinstance(tree, tuple):
        mapped = [tree_map(fn, v, *(r[i] for r in rest))
                  for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*mapped)
        return tuple(mapped)
    return tree  # static metadata


def lane_where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``torch.where`` with a (B,) lane mask broadcast over trailing axes."""
    m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
    return torch.where(m, a, b)


def tree_where(mask: torch.Tensor, a, b):
    """Per-lane select between two structurally equal trees."""
    return tree_map(lambda x, y: lane_where(mask, x, y), a, b)
