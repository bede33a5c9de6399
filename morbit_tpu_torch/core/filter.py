"""Multiobjective filter for relaxable nonlinear constraints, batched.

Counterpart of ``morbit_tpu/core/filter.py`` (reference
``src/AbstractFilterInterface.jl``, ``src/FilterImplementation.jl``): a
fixed-capacity (theta, f) array per lane with masked dominance tests.
``MaxFilter`` compares the scalar ``maximum(fx)`` (``f_dim = 1``),
``StrictFilter`` compares componentwise (``f_dim = m``). Entries are
envelope-shifted on insert. Problems without nonlinear constraints run
with the reference's ``DummyFilter``, a zero-capacity filter that accepts
every point.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FilterState(NamedTuple):
    theta: torch.Tensor     # (B, cap)
    fvals: torch.Tensor     # (B, cap, f_dim)
    count: torch.Tensor     # (B,) int32
    # True once an insert was dropped because the buffer was full (the
    # reference filter is unbounded; the default capacity max_iter + 2 makes
    # this unreachable)
    overflow: torch.Tensor  # (B,) bool


def init_filter(B: int, cap: int, f_dim: int, dtype, device) -> FilterState:
    return FilterState(
        theta=torch.zeros((B, cap), dtype=dtype, device=device),
        fvals=torch.zeros((B, cap, f_dim), dtype=dtype, device=device),
        count=torch.zeros((B,), dtype=torch.int32, device=device),
        overflow=torch.zeros((B,), dtype=torch.bool, device=device))


def compute_constraint_val(l_e, l_i, c_e, c_i):
    """theta = max(0, max|l_e|, max(l_i), max|c_e|, max(c_i)) per lane
    (``AbstractFilterInterface.jl:15-21``); blocks ``(B, k)``, empty ones
    contribute 0."""
    theta = torch.zeros(l_e.shape[:-1], dtype=l_e.dtype, device=l_e.device)
    for block, absolute in ((l_e, True), (l_i, False), (c_e, True), (c_i, False)):
        if block.shape[-1]:
            v = (block.abs() if absolute else block).amax(-1)
            theta = torch.maximum(theta, v)
    return theta


def compute_objective_val(fx, mode: str):
    """'max' -> maximum(fx) as a (B, 1) vector (``FilterImplementation.jl:
    32-34``); 'strict' -> fx componentwise (``:47``)."""
    if mode == "max":
        return fx.amax(-1, keepdim=True)
    return fx


def add_entry(filt: FilterState, theta, f, shift) -> FilterState:
    """Envelope-shifted insert at each lane's fill count
    (``AbstractFilterInterface.jl:32-39``); ``theta`` (B,), ``f`` (B, f_dim)."""
    cap = filt.theta.shape[-1]
    ok = filt.count < cap
    theta_s = theta - shift * theta
    f_s = f - shift * theta[:, None]
    slots = torch.arange(cap, device=theta.device)
    hit = ok[:, None] & (slots == torch.clamp(filt.count, 0, max(cap - 1, 0))[:, None])
    return FilterState(
        theta=torch.where(hit, theta_s[:, None], filt.theta),
        fvals=torch.where(hit[..., None], f_s[:, None, :], filt.fvals),
        count=torch.where(ok, filt.count + 1, filt.count),
        overflow=filt.overflow | ~ok)


def is_acceptable(filt: FilterState, theta, f):
    """(theta, f) against every stored entry of its lane
    (``AbstractFilterInterface.jl:47-58``): dominated iff theta > theta_j
    and any(f > f_j) for some entry j."""
    cap = filt.theta.shape[-1]
    valid = torch.arange(cap, device=theta.device) < filt.count[:, None]
    dominated = (theta[:, None] > filt.theta) & (f[:, None, :] > filt.fvals).any(-1)
    return ~(dominated & valid).any(-1)


def is_acceptable_vs(filt: FilterState, theta, f, theta_k, f_k, shift):
    """(theta, f) against the filter and the current iterate's shifted
    envelope (``AbstractFilterInterface.jl:60-71``)."""
    ok_k = ((theta <= (1.0 - shift) * theta_k)
            | (f <= f_k - shift * theta_k[:, None]).all(-1))
    return ok_k & is_acceptable(filt, theta, f)
