"""Multiobjective filter state.

Counterpart of ``morbit_tpu/core/filter.py``. Problems without nonlinear
constraints run with the reference's ``DummyFilter`` (``filter_mode =
"dummy"``, ``algorithm.py:343`` of the JAX package): every trial point is
acceptable to it and it stores nothing, so the state carries a
zero-capacity filter. The filter's entries and tests arrive with the
constraints slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FilterState(NamedTuple):
    theta: torch.Tensor     # (B, cap)
    fvals: torch.Tensor     # (B, cap, f_dim)
    count: torch.Tensor     # (B,) int32
    overflow: torch.Tensor  # (B,) bool


def init_filter(B: int, cap: int, f_dim: int, dtype, device) -> FilterState:
    return FilterState(
        theta=torch.zeros((B, cap), dtype=dtype, device=device),
        fvals=torch.zeros((B, cap, f_dim), dtype=dtype, device=device),
        count=torch.zeros((B,), dtype=torch.int32, device=device),
        overflow=torch.zeros((B,), dtype=torch.bool, device=device))
