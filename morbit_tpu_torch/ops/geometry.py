"""Box/step geometry, batched over a leading lane axis.

Counterpart of ``morbit_tpu/ops/geometry.py`` (reference
``src/utilities.jl``). Vectors are ``(..., n)``; reductions run over the
last axis, so one call serves a single instance or a batch of lanes.
"""

from __future__ import annotations

import torch

from morbit_tpu_torch.ops.batched_linalg import lane_product


def project_into_box(z, lb, ub):
    """``min.(max.(z, lb), ub)`` — reference ``src/utilities.jl:122``."""
    return torch.minimum(torch.maximum(z, lb), ub)


def local_bounds(x, delta, lb, ub):
    """Global box intersected with the trust-region box
    (``_local_bounds``, ``src/utilities.jl:290-294``). ``delta`` is a
    scalar or a ``(...,)`` tensor of per-lane radii."""
    if isinstance(delta, torch.Tensor) and delta.dim() == x.dim() - 1:
        delta = delta[..., None]
    return torch.maximum(lb, x - delta), torch.minimum(ub, x + delta)


def _crossing_sigmas(ax, b, ad, sense_lb: bool):
    """Step lengths at which ``ax + sigma*ad`` crosses the bound ``b``
    (``_intersect_bound_vec``, ``src/utilities.jl:126-152``)."""
    inf = torch.full_like(ax, float("inf"))
    zero = torch.zeros_like(ax)
    tmp = b - ax
    dir_nz = ad != 0
    tmp_z = tmp == 0
    safe_ad = torch.where(dir_nz, ad, torch.ones_like(ad))
    sigma_cross = tmp / safe_ad
    if sense_lb:
        onbound = torch.where(ad > 0, inf, zero)
    else:
        onbound = torch.where(ad < 0, inf, zero)
    sigma = torch.where(tmp_z, onbound, sigma_cross)
    return torch.where(dir_nz | tmp_z, sigma, inf)


def intersect_bounds(x, d, lb=None, ub=None, A_ineq=None, b_ineq=None,
                     ret_mode: str = "pos"):
    """Maximum step ``sigma`` with ``lb <= x + sigma*d <= ub`` and
    ``A_ineq @ (x + sigma*d) <= b_ineq`` (``src/utilities.jl:172-221``).

    ``ret_mode``: 'pos' | 'neg' | 'absmax' | 'both'."""
    sigmas = []
    if lb is not None:
        sigmas.append(_crossing_sigmas(x, lb, d, sense_lb=True))
    if ub is not None:
        sigmas.append(_crossing_sigmas(x, ub, d, sense_lb=False))
    if A_ineq is not None and A_ineq.shape[-2] > 0:
        ax = lane_product(A_ineq, x[..., None])[..., 0]
        ad = lane_product(A_ineq, d[..., None])[..., 0]
        b = torch.zeros_like(ax) if b_ineq is None else b_ineq
        sigmas.append(_crossing_sigmas(ax, b, ad, sense_lb=False))

    inf = torch.full(x.shape[:-1], float("inf"), dtype=x.dtype, device=x.device)
    if not sigmas:
        if ret_mode == "neg":
            return -inf
        if ret_mode == "both":
            return -inf, inf
        return inf

    sigma = torch.cat(sigmas, dim=-1)
    nonneg = sigma >= 0
    zero = torch.zeros_like(inf)
    pos_vals = torch.where(nonneg, sigma, torch.full_like(sigma, float("inf")))
    sigma_pos = torch.where(nonneg.any(-1), pos_vals.amin(-1), zero)
    neg_vals = torch.where(~nonneg, sigma, torch.full_like(sigma, -float("inf")))
    sigma_neg = torch.where((~nonneg).any(-1), neg_vals.amax(-1), zero)

    d_is_zero = (d == 0).all(-1)
    sigma_pos = torch.where(d_is_zero, inf, sigma_pos)
    sigma_neg = torch.where(d_is_zero, inf, sigma_neg)

    if ret_mode == "pos":
        return sigma_pos
    if ret_mode == "neg":
        return sigma_neg
    if ret_mode == "absmax":
        return torch.where(sigma_pos.abs() >= sigma_neg.abs(), sigma_pos,
                           sigma_neg)
    if ret_mode == "both":
        return sigma_neg, sigma_pos
    raise ValueError(f"unknown ret_mode {ret_mode!r}")


def intersect_box(x, d, lb, ub, ret_mode: str = "absmax"):
    """``intersect_box`` (``src/utilities.jl:285-287``)."""
    return intersect_bounds(x, d, lb, ub, ret_mode=ret_mode)
