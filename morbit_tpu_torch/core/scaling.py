"""Variable scaling (diagonal affine transform).

Counterpart of ``morbit_tpu/core/scaling.py`` (reference
``src/VarScaler.jl``): finitely box-constrained problems are scaled onto
the unit cube ``[0,1]^n``, otherwise no scaling. ``x_hat = scale * x +
offset``; the fields are ``(n,)`` for the solver's own scaler and
``(B, n)`` inside the batched state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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


def get_var_scaler(lb, ub, mode: str = "default") -> VarScaler:
    """Pick the scaler from the config setting (``VarScaler.jl:195-238``):
    'default' scales a finite box onto the unit cube, 'none' disables
    scaling. The Jacobian-estimating 'auto' mode is not ported yet."""
    if mode == "auto":
        raise NotImplementedError(
            "var_scaler='auto' is not ported to morbit_tpu_torch yet "
            "(ROADMAP queue 1 item 10)")
    if mode not in ("default", "none"):
        raise ValueError(f"unknown var_scaler {mode!r}")
    finite = bool(torch.isfinite(lb).all() and torch.isfinite(ub).all())
    if mode == "default" and finite:
        return unit_cube_scaling(lb, ub)
    return no_scaling(lb, ub)

