"""Algorithm configuration.

Static dataclass holding all trust-region hyperparameters, field for field
the JAX package's ``AlgorithmConfig`` (reference defaults from
``src/AbstractConfigInterface.jl:11-96`` and
``src/ConfigImplementations.jl:13-98``). The working dtype is chosen by the
caller (float64 for parity runs on the CPU, float32 for throughput on the
GPU).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Union

# sqrt(eps(Float32)) — reference default for f_tol_rel et al.
# (src/AbstractConfigInterface.jl:42)
_SQRT_EPS_F32 = math.sqrt(2.0 ** -23)


@dataclasses.dataclass(frozen=True)
class AlgorithmConfig:
    """Trust-region algorithm hyperparameters (defaults match the reference)."""

    # --- criticality test (src/AbstractConfigInterface.jl:14-19)
    eps_crit: float = 1e-3
    gamma_crit: float = 0.51
    max_critical_loops: int = 5

    # --- trust region radii (":28-31")
    delta_0: float = 0.1
    delta_max: float = 0.5

    # --- budgets (":35-38")
    max_evals: int = 2 ** 31 - 1
    max_iter: int = 50
    max_restoration_evals: int = -1

    # --- stopping tolerances (":42-61")
    f_tol_rel: float = _SQRT_EPS_F32
    x_tol_rel: float = _SQRT_EPS_F32
    f_tol_abs: float = -1.0
    x_tol_abs: float = -1.0
    omega_tol_rel: float = 10.0 * _SQRT_EPS_F32
    delta_tol_rel: float = _SQRT_EPS_F32
    omega_tol_abs: float = -math.inf
    delta_tol_abs: float = _SQRT_EPS_F32
    stepnorm_tol_abs: float = 0.0

    # --- descent method (":64"): 'steepest_descent' | a descent config object
    descent_method: Union[str, object] = "steepest_descent"

    # --- acceptance test (":67-72")
    strict_acceptance_test: bool = True
    nu_success: float = 0.2
    nu_accept: float = 0.0
    mu: float = 2e3
    beta: float = 1e3

    # --- radius update (":75-78"): 'standard' | 'steplength'
    radius_update_method: str = "standard"
    gamma_grow: float = 2.0
    gamma_shrink: float = 0.75
    gamma_shrink_much: float = 0.51

    # --- grouping (":80")
    combine_models: bool = True

    # --- filter (":82-90")
    filter_type: str = "max"  # 'max' | 'strict' | 'dummy'
    filter_shift: float = 1e-4
    filter_kappa_psi: float = 1e-4
    filter_psi: float = 1.0
    filter_kappa_delta: float = 0.7
    filter_kappa_mu: float = 100.0
    filter_mu: float = 0.01
    # fixed filter capacity; <= 0 means max_iter + 2 (see
    # resolved_filter_capacity)
    filter_capacity: int = -1

    # --- variable scaling (":92-94"): 'default' | 'none' | 'auto'
    var_scaler: str = "default"
    untransform_final_database: bool = False
    var_scaler_update: str = "none"

    # --- database storage (":22", ``use_db``)
    use_db: bool = True

    # --- knobs without a reference analogue ----------------------------------
    # rows of each per-group evaluation database; <= 0 means "auto"
    db_capacity: int = -1
    # fixed iteration budget of the batched ADMM QP solver
    qp_iters: int = 400
    qp_polish: bool = True
    # residual early exit for the ADMM rho-stages; 0 = fixed trips
    qp_exit_eps: float = 0.0
    # trajectory buffer length (IterSaveable stamps); <= 0 -> max_iter + 2
    trajectory_capacity: int = -1
    # stamp each iteration's per-group model training sets (RBF only)
    save_model_meta: bool = False

    def resolved_db_capacity(self, n_vars: int, max_model_points: int,
                             sites_per_iter: int = 0) -> int:
        """Database row capacity heuristic.

        ``max_model_points`` is the largest per-rebuild working set of any
        group; ``sites_per_iter`` bounds how many NEW sites a group may
        insert per iteration."""
        if self.db_capacity > 0:
            return self.db_capacity
        if not self.use_db:
            return ((3 + self.max_critical_loops) * max_model_points
                    + 2 * sites_per_iter + 8)
        # initial point + per-iteration trial point + model construction
        # sites + criticality rebuilds
        per_iter = (max(2 * n_vars, sites_per_iter) + 4
                    + (2 + self.max_critical_loops))
        cap = 1 + self.max_iter * per_iter + max_model_points
        if self.max_evals < 2 ** 30:
            cap = min(cap, int(self.max_evals) + max_model_points + self.max_iter + 8)
        return max(cap, 4 * (n_vars + 2))

    def resolved_filter_capacity(self) -> int:
        """Filter row capacity: explicit value, else ``max_iter + 2`` (the
        filter gains <= 1 entry per iteration, ``algorithm.jl:875-877``)."""
        if self.filter_capacity > 0:
            return self.filter_capacity
        return self.max_iter + 2

    def resolved_trajectory_capacity(self) -> int:
        if self.trajectory_capacity > 0:
            return self.trajectory_capacity
        return self.max_iter + 2
