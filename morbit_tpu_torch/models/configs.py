"""Surrogate model configurations (static dataclasses).

Mirrors the JAX package's ``morbit_tpu/models/configs.py``. This package
solves :class:`ExactConfig` and :class:`RbfConfig` groups; every other
config raises ``NotImplementedError`` naming the slice that ports it
(:data:`LATER_SLICE`), as does ``RbfConfig(use_max_points=True)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

from morbit_tpu_torch.ops.rbf import RBF_KERNELS

#: where each surrogate family not yet ported lands in the port's order
LATER_SLICE = {
    "TaylorConfig": "the Taylor slice (ROADMAP queue 1 item 7)",
    "LagrangeConfig": "the Lagrange slice (ROADMAP queue 1 item 8)",
}


@dataclasses.dataclass(frozen=True)
class ExactConfig:
    """No surrogate: forward evals/Jacobians to the true function.

    Jacobians come from the user's ``jac`` callback, else
    ``torch.func.jacrev`` (``src/DiffFn.jl:56``)."""

    max_evals: int = 2 ** 31 - 1

    @property
    def combinable(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class RbfConfig:
    """RBF surrogate configuration (``src/models/RbfModel.jl:66-112``)."""

    kernel: str = "cubic"
    # float, or a callable Delta -> shape parameter (``RbfModel.jl:135-143``);
    # NaN -> the kernel's default
    shape_parameter: Union[float, Callable] = math.nan
    polynomial_degree: int = 1
    theta_enlarge_1: float = 2.0
    theta_enlarge_2: float = 2.0
    theta_pivot: float = 0.25
    theta_pivot_cholesky: float = 1e-7
    # declared but unread in the reference too (``RbfModel.jl:89``)
    require_linear: bool = True
    max_model_points: int = -1   # -1 -> (n+1)(n+2)/2
    use_max_points: bool = False
    optimized_sampling: bool = True
    max_evals: int = 2 ** 31 - 1

    def __post_init__(self):
        if self.kernel not in RBF_KERNELS:
            raise ValueError(f"kernel must be one of {RBF_KERNELS}, got {self.kernel!r}")
        if not (self.theta_enlarge_1 >= 1 and self.theta_enlarge_2 >= 1):
            raise ValueError("theta_enlarge_1 and theta_enlarge_2 must be >= 1")
        if not self.theta_enlarge_1 * self.theta_pivot <= 1 + 1e-12:
            raise ValueError("theta_enlarge_1 * theta_pivot must be <= 1")

    @property
    def combinable(self) -> bool:
        return True

    def signature(self):
        """Geometry signature for cross-group training-set reuse
        (``RbfModel.jl:114``)."""
        return (self.theta_pivot, self.theta_enlarge_1, self.theta_enlarge_2,
                self.optimized_sampling)

    def resolved_max_points(self, n_vars: int) -> int:
        if self.max_model_points > 0:
            return max(self.max_model_points, 1)
        return (n_vars + 1) * (n_vars + 2) // 2


SurrogateConfig = Union[ExactConfig, RbfConfig]


def check_ported(cfg):
    """Return ``cfg`` if this package can solve it, else raise."""
    if isinstance(cfg, ExactConfig):
        return cfg
    if isinstance(cfg, RbfConfig):
        if cfg.use_max_points:
            raise NotImplementedError(
                "RbfConfig(use_max_points=True) is not ported to "
                "morbit_tpu_torch yet: its random round-4 candidates come from "
                "jax.random in the reference, and they arrive with ROADMAP "
                "queue 1 item 11")
        return cfg
    name = type(cfg).__name__
    where = LATER_SLICE.get(name, "a later slice of the port")
    raise NotImplementedError(
        f"{name} surrogates are not ported to morbit_tpu_torch yet: they "
        f"arrive with {where}. ExactConfig and RbfConfig are supported.")
