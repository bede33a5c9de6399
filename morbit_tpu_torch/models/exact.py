"""Exact "surrogate": forwards to the true function.

Counterpart of ``morbit_tpu/models/exact.py`` (reference
``src/models/ExactModel.jl:22-119``). Evaluation at scaled sites
untransforms and calls the true function (counted budget); the Jacobian
applies the unscaling chain rule ``Jf(x) diag(1/scale)``. Always fully
linear.
"""

from __future__ import annotations

import torch

from morbit_tpu_torch.core import scaling
from morbit_tpu_torch.models.base import SurrogateOps


def broadcast_scaler(scal: scaling.VarScaler, x_s: torch.Tensor):
    """Insert singleton axes so (B, n) scaler fields broadcast against
    sites ``(B, ..., n)``."""
    extra = x_s.dim() - scal.scale.dim()
    if extra <= 0:
        return scal
    shape = scal.scale.shape[:-1] + (1,) * extra + scal.scale.shape[-1:]
    return scaling.VarScaler(*(f.reshape(shape) for f in scal))


class ExactOps(SurrogateOps):
    counts_on_eval = True

    def init_state(self, B: int, device):
        return ()

    def eval(self, state, x_s, scal):
        x = scaling.untransform(broadcast_scaler(scal, x_s), x_s)
        return self.group.eval_unscaled(x)

    def jac(self, state, x_s, scal):
        x = scaling.untransform(scal, x_s)
        J = self.group.jac_unscaled(x)           # (B, m, n) wrt unscaled x
        return J / scal.scale[..., None, :]      # d(untransform) = diag(1/scale)

    def fully_linear(self, state):
        return True
