"""Surrogate model configurations (static dataclasses).

Mirrors the JAX package's ``morbit_tpu/models/configs.py``. Only
:class:`ExactConfig` is solved by this package so far. :class:`RbfConfig`,
the default objective model, is carried as inert data with the JAX
package's fields and defaults; :class:`morbit_tpu_torch.MOP` refuses it and
every other non-exact config with ``NotImplementedError`` naming the slice
that ports it (:data:`LATER_SLICE`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

#: where each surrogate family not yet ported lands in the port's order
LATER_SLICE = {
    "RbfConfig": "the RBF surrogate slice (with the selection kernels)",
    "TaylorConfig": "the Taylor slice",
    "LagrangeConfig": "the Lagrange slice",
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
    shape_parameter: Union[float, Callable] = math.nan
    polynomial_degree: int = 1
    theta_enlarge_1: float = 2.0
    theta_enlarge_2: float = 2.0
    theta_pivot: float = 0.25
    theta_pivot_cholesky: float = 1e-7
    require_linear: bool = True
    max_model_points: int = -1
    use_max_points: bool = False
    optimized_sampling: bool = True
    max_evals: int = 2 ** 31 - 1

    @property
    def combinable(self) -> bool:
        return True


SurrogateConfig = Union[ExactConfig, RbfConfig]


def require_exact(cfg) -> ExactConfig:
    """Return ``cfg`` if this package can solve it, else raise."""
    if isinstance(cfg, ExactConfig):
        return cfg
    name = type(cfg).__name__
    where = LATER_SLICE.get(name, "a later slice of the port")
    raise NotImplementedError(
        f"{name} surrogates are not ported to morbit_tpu_torch yet: they "
        f"arrive with {where}. Only ExactConfig objectives are supported.")
