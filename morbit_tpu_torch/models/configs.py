"""Surrogate model configurations (static dataclasses).

Mirrors the JAX package's ``morbit_tpu/models/configs.py``: one config
type per model family of the reference (``ExactModel.jl``,
``RbfModel.jl``, ``TaylorModel.jl``, ``LagrangeModel.jl``), with the JAX
package's fields, defaults and checks. A config type this package does
not know raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

from morbit_tpu_torch.ops.rbf import RBF_KERNELS

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


@dataclasses.dataclass(frozen=True)
class TaylorConfig:
    """Degree-1/2 Taylor polynomial models (``src/models/TaylorModel.jl``).

    ``mode``: 'fd' builds the derivatives by finite differences through the
    database (``TaylorModel.jl:70-93``), on the stencil of ``fd_stamp``;
    'callback' takes them from the user's ``jac``/``hess`` callbacks or
    autodiff (``TaylorCallbackConfig``, ``TaylorModel.jl:293-327``).
    ``hess_stamp``: 'compose' builds the Hessian as finite differences of
    finite differences (the reference's recursion); 'cfd2'/'cfd2_4' take a
    direct second-derivative stamp on the diagonal."""

    degree: int = 2
    mode: str = "fd"
    fd_stamp: str = "cfd1"
    fd_stepsize: float = 0.001
    hess_stamp: str = "compose"
    max_evals: int = 2 ** 31 - 1

    def __post_init__(self):
        from morbit_tpu_torch.models.taylor import STAMPS, STAMPS2

        if not 1 <= self.degree <= 2:
            raise ValueError(f"degree must be 1 or 2, got {self.degree}")
        if self.mode not in ("fd", "callback"):
            raise ValueError(f"mode must be 'fd' or 'callback', got {self.mode!r}")
        if self.fd_stamp not in STAMPS:
            raise ValueError(f"fd_stamp must be one of {tuple(STAMPS)}")
        if not (self.hess_stamp == "compose" or self.hess_stamp in STAMPS2):
            raise ValueError(f"hess_stamp must be 'compose' or one of {tuple(STAMPS2)}")

    @property
    def combinable(self) -> bool:
        return self.mode == "fd"

    def resolved_max_points(self, n_vars: int) -> int:
        """Stencil sites: the sites one rebuild adds to the database."""
        if self.mode != "fd":
            return 1
        from morbit_tpu_torch.models.taylor import _build_stencil

        O, _, _ = _build_stencil(n_vars, self.degree, self.fd_stamp, self.hess_stamp)
        return int(O.shape[0])


@dataclasses.dataclass(frozen=True)
class LagrangeConfig:
    """Degree-1/2 Lagrange interpolation models (``src/models/LagrangeModel.jl``).

    The poised set follows Conn et al. Algorithms 6.2/6.3; the NLopt
    polynomial maximization is a grid sweep and multistart projected
    gradient ascent on |l_i| over the unit box (``ascent_restarts`` starts,
    ``ascent_iters`` steps each). ``save_path`` names a directory where the
    static stamp of ``optimized_sampling=False`` is saved and looked up
    (``LagrangeModel.jl:77-80,537-573``)."""

    degree: int = 2
    theta_enlarge: float = 2.0
    lambda_poise: float = 1.5
    allow_not_linear: bool = False
    optimized_sampling: bool = True
    max_evals: int = 2 ** 31 - 1
    ascent_restarts: int = 8
    ascent_iters: int = 40
    save_path: Optional[str] = None

    def __post_init__(self):
        if not 1 <= self.degree <= 2:
            raise ValueError(f"degree must be 1 or 2, got {self.degree}")

    @property
    def combinable(self) -> bool:
        return True

    def resolved_max_points(self, n_vars: int) -> int:
        """Poised-set size p: the sites one rebuild may add."""
        if self.degree == 1:
            return n_vars + 1
        return (n_vars + 1) * (n_vars + 2) // 2


SurrogateConfig = Union[ExactConfig, RbfConfig, TaylorConfig, LagrangeConfig]


def check_ported(cfg):
    """Return ``cfg`` if this package can solve it, else raise."""
    if isinstance(cfg, (ExactConfig, RbfConfig, TaylorConfig, LagrangeConfig)):
        return cfg
    raise NotImplementedError(
        f"{type(cfg).__name__} surrogates are not ported to morbit_tpu_torch "
        "(ROADMAP queue 1 item 11): ExactConfig, RbfConfig, TaylorConfig and "
        "LagrangeConfig are supported.")
