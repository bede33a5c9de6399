"""Variable scaling (diagonal affine transform).

Counterpart of ``morbit_tpu/core/scaling.py`` (reference
``src/VarScaler.jl``): finitely box-constrained problems are scaled onto
the unit cube ``[0,1]^n``, otherwise no scaling. ``x_hat = scale * x +
offset``; the fields are ``(n,)`` for the solver's own scaler and
``(B, n)`` inside the batched state. The Jacobian-based estimates of the
``'auto'`` scaler (:func:`estimate_auto_scaler`, on the host) and of the
per-iteration ``var_scaler_update='model'`` update
(:func:`estimate_linear_scaling_traced`, batched over lanes) follow
``VarScaler.jl:139-193, 240-260``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MIN_SCALING_FACTOR = 1e-8
MAX_SCALING_FACTOR = 1e8


class VarScaler(NamedTuple):
    """Diagonal affine scaler ``x_hat = scale*x + offset``."""

    scale: torch.Tensor
    offset: torch.Tensor
    lb_scaled: torch.Tensor
    ub_scaled: torch.Tensor


def transform(scal: VarScaler, x):
    return scal.scale * x + scal.offset


def untransform(scal: VarScaler, x_scaled):
    return (x_scaled - scal.offset) / scal.scale


def no_scaling(lb, ub) -> VarScaler:
    """``NoVarScaling`` (``VarScaler.jl:62-89``)."""
    return VarScaler(scale=torch.ones_like(lb), offset=torch.zeros_like(lb),
                     lb_scaled=lb, ub_scaled=ub)


def unit_cube_scaling(lb, ub) -> VarScaler:
    """Map the finite box onto [0,1]^n (``VarScaler.jl:205-213``)."""
    w = ub - lb
    scale = 1.0 / w
    offset = -lb * scale
    return VarScaler(scale=scale, offset=offset,
                     lb_scaled=torch.zeros_like(lb),
                     ub_scaled=torch.ones_like(ub))


def estimate_auto_scaler(jacobian, lb, ub, dtype=torch.float64,
                         device="cpu") -> VarScaler:
    """Jacobian-based scaling factors for (partially) unbounded problems
    (Lasdon & Beck; ``_estimate_linear_scaling`` + ``_scaling_factors``,
    ``VarScaler.jl:139-193``), computed in NumPy on the host.

    Bounded coordinates get unit-cube factors ``1/w``; unbounded ones get
    ``exp(mean(log |J_col|))``-style factors matched to the bounded columns'
    mean magnitude, clipped to [1e-8, 1e8]. The offset is zero."""
    J = np.asarray(jacobian, float)
    lb = np.asarray(lb, float)
    ub = np.asarray(ub, float)
    w = ub - lb
    bounded = np.isfinite(w)
    factors = np.ones(J.shape[1])

    def col_factor(col, target=None):
        nz = col != 0
        if not nz.any():
            return 1.0
        exp_arg = -np.sum(np.log(np.abs(col[nz])))
        if target is not None:
            exp_arg += np.sum(np.log(np.abs(target[nz])))
        return float(np.exp(exp_arg / nz.sum()))

    if bounded.any():
        target_val = np.mean(np.abs(J[:, bounded] / w[bounded][None, :]), axis=1)
        for j in np.where(~bounded)[0]:
            factors[j] = col_factor(J[:, j], target_val)
        factors[bounded] = 1.0 / w[bounded]
    else:
        for j in range(J.shape[1]):
            factors[j] = col_factor(J[:, j])
    factors = np.clip(factors, MIN_SCALING_FACTOR, MAX_SCALING_FACTOR)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    scale = t(factors)
    return VarScaler(scale=scale, offset=torch.zeros_like(scale),
                     lb_scaled=scale * t(lb), ub_scaled=scale * t(ub))


def estimate_linear_scaling_traced(J, lb, ub, bounded_mask) -> VarScaler:
    """The ``'model'`` update's estimate (``new_var_scaler``,
    ``VarScaler.jl:240-260``) for every lane: ``J (B, rows, n)`` are the
    lanes' Jacobians w.r.t. the unscaled variables, ``lb``/``ub`` ``(n,)``
    the box and ``bounded_mask`` a numpy bool mask of its finitely bounded
    coordinates. The factors are those of :func:`estimate_auto_scaler`,
    with a zero column giving 1 and zero targets left out; returns a
    ``(B, n)`` scaler with zero offset."""
    bounded_mask = np.asarray(bounded_mask)
    w = ub - lb
    target = None
    if bounded_mask.any():
        cols = torch.as_tensor(np.nonzero(bounded_mask)[0], device=J.device)
        target = (J[..., cols] / w[cols]).abs().mean(-1)          # (B, rows)
    ones = torch.ones((), dtype=J.dtype, device=J.device)
    factors = []
    for j in range(J.shape[-1]):
        if bounded_mask[j]:
            factors.append((1.0 / w[j]).expand(J.shape[0]))
            continue
        col = J[..., j]
        nz = col != 0
        nnz = nz.sum(-1)
        exp_arg = -torch.log(torch.where(nz, col.abs(), ones)).sum(-1)
        if target is not None:
            safe_t = torch.where(nz & (target != 0), target.abs(), ones)
            exp_arg = exp_arg + torch.log(safe_t).sum(-1)
        factors.append(torch.where(nnz > 0,
                                   torch.exp(exp_arg / torch.clamp(nnz, min=1)), ones))
    scale = torch.clamp(torch.stack(factors, dim=-1), MIN_SCALING_FACTOR,
                        MAX_SCALING_FACTOR)
    return VarScaler(scale=scale, offset=torch.zeros_like(scale),
                     lb_scaled=scale * lb, ub_scaled=scale * ub)


def get_var_scaler(lb, ub, mode: str = "default") -> VarScaler:
    """Pick the scaler from the config setting (``VarScaler.jl:195-238``):
    'default' and 'auto' scale a finite box onto the unit cube, 'none'
    disables scaling. (With an unbounded box and a starting point,
    ``Solver`` estimates the 'auto' scaler from a Jacobian instead,
    :func:`estimate_auto_scaler`.)"""
    if mode not in ("default", "auto", "none"):
        raise ValueError(f"unknown var_scaler {mode!r}")
    finite = bool(torch.isfinite(lb).all() and torch.isfinite(ub).all())
    if mode in ("default", "auto") and finite:
        return unit_cube_scaling(lb, ub)
    return no_scaling(lb, ub)

