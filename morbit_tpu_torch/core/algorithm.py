"""Main trust-region algorithm, batched over lanes.

Counterpart of ``morbit_tpu/core/algorithm.py`` (reference
``src/algorithm.jl``). The JAX package writes one instance and ``vmap``s
it; here every state tensor carries a leading lane axis B and the control
flow reproduces vmap's semantics, not those of a sequential loop:

* ``lax.while_loop`` in ``solve_from_state`` becomes a Python loop that
  runs while any lane has ``stop_code == CONTINUE``. Each trip computes
  :meth:`Solver.iterate` for all lanes and writes back only the lanes that
  were still running (:func:`tree_where` over every state leaf), so
  finished lanes stay bit-frozen, eval counters and trajectory included.
  The loop's ``.any()`` is the one host sync per trip.
* every ``lax.cond`` computes both branches, then selects per lane.

A single :func:`optimize` run is B=1 of the same code. The port covers
exact, RBF, Taylor and Lagrange models, composite functions, steepest
descent and Pascoletti-Serafini descent, box constraints, linear and
nonlinear constraints through the filter, the normal step and restoration,
the ``'auto'`` scaler and the per-iteration ``'model'`` scaler update,
``use_db=False``, database recycling (``populated_db``) and
``untransform_final_database``, the QP's early exit (``qp_exit_eps``),
``RbfConfig(use_max_points=True)`` and host (NumPy) functions.

With a host function in the problem, every true evaluation whose result a
lane may discard is masked to the lanes that keep it (``keep``, threaded
from :meth:`Solver.iterate` down to the trial point, the normal step's
candidate and restoration), so that the user's code runs only at counted
sites, as the JAX package's gated evaluations do in a single run. Without
one, ``keep`` is None and no mask is formed.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from morbit_tpu_torch.core import database as dbm
from morbit_tpu_torch.core import filter as flt
from morbit_tpu_torch.core import scaling
from morbit_tpu_torch.core.config import AlgorithmConfig
from morbit_tpu_torch.core.descent import (LinearizedConstraints,
                                           SteepestDescentConfig, backtrack,
                                           initial_stepsize, normal_step,
                                           ps_subsolver_budgets,
                                           resolve_descent_config,
                                           steepest_descent_direction)
from morbit_tpu_torch.core.enums import ITER_TYPE, RADIUS_UPDATE, STOP_CODE
from morbit_tpu_torch.core.mop import MOP, NL_EQ, NL_INEQ, CompiledMOP, compile_mop
from morbit_tpu_torch.models.configs import LagrangeConfig, TaylorConfig
from morbit_tpu_torch.models.container import SurrogateContainer, chain_rule
from morbit_tpu_torch.ops import prng
from morbit_tpu_torch.ops.batched_linalg import lane_matmul, lane_matvec, lane_product
from morbit_tpu_torch.ops.boxopt import halton_grid, maximize_in_box
from morbit_tpu_torch.ops.geometry import project_into_box
from morbit_tpu_torch.utils.logging import LiveLog
from morbit_tpu_torch.utils.tree import lane_where, tree_map, tree_where

#: criticality micro-step modes (``SolverState.ints[:, 3]``): the
#: criticality routine (``algorithm.jl:523-613``) runs as micro-steps of the
#: outer loop, one rebuild pass per trip, as in the JAX package
_MODE_NORMAL, _MODE_CRIT_PRE, _MODE_CRIT_LOOP = 0, 1, 2
#: the restoration loop checks for active lanes on the host once in this
#: many iterations (lanes that finished in between run masked no-op trips)
RESTORATION_SYNC_EVERY = 8


_mv = lane_matvec


@dataclasses.dataclass(frozen=True)
class TrajectoryState:
    """Per-iteration stamps (the ``IterSaveable`` buffer,
    ``src/IterDataIterSaveable.jl:189-216``), packed as in the JAX package
    into one ``(B, T, W)`` tensor with layout ``[x (n) | fx (m) | delta |
    rho | omega | steplength | it_stat | x_indices (G) | model_meta (MW)]``;
    ``MW > 0`` only with ``AlgorithmConfig.save_model_meta``."""

    data: torch.Tensor   # (B, T, W)
    count: torch.Tensor  # (B,) int32
    n: int
    m: int
    G: int
    MW: int = 0

    @property
    def x(self):
        return self.data[..., : self.n]

    @property
    def fx(self):
        return self.data[..., self.n: self.n + self.m]

    def _col(self, j):
        return self.data[..., self.n + self.m + j]

    @property
    def delta(self):
        return self._col(0)

    @property
    def rho(self):
        return self._col(1)

    @property
    def omega(self):
        return self._col(2)

    @property
    def steplength(self):
        return self._col(3)

    @property
    def it_stat(self):
        return self._col(4).to(torch.int32)

    @property
    def x_indices(self):
        o = self.n + self.m + 5
        return self.data[..., o: o + self.G].to(torch.int32)

    @property
    def model_meta(self):
        """(B, T, MW) per-iteration training-set provenance, split per group
        by ``SurrogateOps.train_stamp_len`` (empty unless
        ``save_model_meta``)."""
        o = self.n + self.m + 5 + self.G
        return self.data[..., o: o + self.MW].to(torch.int32)


_INT_COLS = {"iter_counter": 0, "last_it_stat": 1, "stop_code": 2,
             "crit_mode": 3, "crit_nloops": 4}
_X_IDX_OFF = 5


@dataclasses.dataclass(frozen=True)
class SolverState:
    """Complete batched solver state. The int32 bookkeeping is packed into
    ``ints`` (B, 5 + G) = [iter_counter, last_it_stat, stop_code, crit_mode,
    crit_nloops, x_indices (G)] and the radii into ``dlt`` (B, 2) = [delta,
    delta_loc], the JAX package's layout; named views and :meth:`replace`
    keep the logical field API."""

    x: torch.Tensor      # (B, n) unscaled iterate
    x_s: torch.Tensor    # (B, n) scaled iterate
    fx: torch.Tensor     # (B, m_obj)
    l_e: torch.Tensor    # (B, p) linear equality values  A~ x_s - b~
    l_i: torch.Tensor    # (B, q) linear inequality values
    c_e: torch.Tensor    # (B, m_ce) nonlinear equality values
    c_i: torch.Tensor    # (B, m_ci) nonlinear inequality values
    dlt: torch.Tensor    # (B, 2)
    ints: torch.Tensor   # (B, 5 + G) int32
    groups: tuple        # tuple[GroupState]
    filter: flt.FilterState
    traj: TrajectoryState
    scal: scaling.VarScaler  # (B, n) fields
    #: (B, 2) PRNG key words (int64 holding uint32) when a group draws
    #: random numbers (``RbfConfig(use_max_points=True)``), else None
    key: Optional[torch.Tensor] = None
    #: the per-lane problem data of a parametric problem
    #: (``parametric_multistart``): its leaves, (B, ...) each; else ()
    theta: tuple = ()

    @property
    def delta(self):
        return self.dlt[..., 0]

    @property
    def delta_loc(self):
        return self.dlt[..., 1]

    @property
    def iter_counter(self):
        return self.ints[..., 0]

    @property
    def last_it_stat(self):
        return self.ints[..., 1]

    @property
    def stop_code(self):
        return self.ints[..., 2]

    @property
    def crit_mode(self):
        return self.ints[..., 3]

    @property
    def crit_nloops(self):
        return self.ints[..., 4]

    @property
    def x_indices(self):
        return self.ints[..., _X_IDX_OFF:]

    def replace(self, **kw):
        ints = kw.pop("ints", self.ints)
        cols = {c: kw.pop(name) for name, c in _INT_COLS.items() if name in kw}
        x_idx = kw.pop("x_indices", None)
        if cols or x_idx is not None:
            ints = ints.clone()
            for c, v in cols.items():
                ints[..., c] = v
            if x_idx is not None:
                ints[..., _X_IDX_OFF:] = x_idx
        dlt = kw.pop("dlt", self.dlt)
        if "delta" in kw or "delta_loc" in kw:
            dlt = dlt.clone()
            if "delta" in kw:
                dlt[..., 0] = kw.pop("delta")
            if "delta_loc" in kw:
                dlt[..., 1] = kw.pop("delta_loc")
        return dataclasses.replace(self, ints=ints, dlt=dlt, **kw)


class OptimizeResult(NamedTuple):
    x: torch.Tensor
    fx: torch.Tensor
    stop_code: torch.Tensor
    n_iterations: torch.Tensor
    n_evals: torch.Tensor
    state: SolverState
    #: outer trips of the solve loop (iterations plus criticality micro-steps
    #: of the slowest lane); one host sync each
    trips: int
    #: trips of each stage of a staged runner, the to-completion stages last
    stage_trips: tuple = ()


def resolve_device(device) -> torch.device:
    """The solver runs on CUDA unless the caller asks for another device;
    without CUDA that default raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "morbit_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def _full_precision_matmuls():
    """Full float32 matmuls inside the solver's calls, mirroring the JAX
    package's ``_highest_matmul_precision`` (algorithm.py:252-265): TF32
    products spoil the tiny Gram/KKT/QP solves (about 5x worse convergence
    at f32 in the JAX package's measurements). Both TF32 flags are False
    inside and hold the caller's values again on exit, an exception
    included; nested scopes restore the outer scope's values."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Solver:
    """Static solver object: ``initialize`` / ``iterate`` / ``solve`` on
    batched state.

    ``log_level`` (``live_log`` sets at least 3) prints the JAX package's
    live lines for lane 0 while the run goes (algorithm.py:274-283): at 3
    a banner an iteration, at 4 the normal step, restoration, criticality
    test and pass and acceptance, at 5 each group's model build. The lines
    are gathered on the device and printed once a trip
    (``utils/logging.LiveLog``); below 3 nothing is gathered."""

    def __init__(self, mop: CompiledMOP, ac: Optional[AlgorithmConfig] = None,
                 dtype=torch.float64, device="cuda", x0_hint=None, live_log: bool = False,
                 log_level: int = 0):
        self.log_level = max(int(log_level), 3 if live_log else 0)
        self.live_log = self.log_level >= 3
        self._log = LiveLog(self.log_level) if self.live_log else None
        #: where a trip's restoration line goes in the live log
        self._restoration_mark = None
        self.mop = mop
        self.ac = ac = ac or AlgorithmConfig()
        self.dtype = dtype
        self.device = torch.device(device)
        if ac.var_scaler_update not in ("none", "model"):
            raise ValueError(f"unknown var_scaler_update {ac.var_scaler_update!r}")
        finite = bool(np.isfinite(mop.lb).all() and np.isfinite(mop.ub).all())
        if ac.var_scaler == "auto" and not finite and x0_hint is not None:
            # the Jacobian estimate of the 'auto' scaler (``get_var_scaler``'s
            # :auto branch, ``VarScaler.jl:214-234``) at a perturbed start,
            # as the JAX package draws it (algorithm.py:295-304)
            np_dtype = torch.empty((), dtype=dtype).numpy().dtype
            lb, ub = np.asarray(mop.lb, np_dtype), np.asarray(mop.ub, np_dtype)
            rng = np.random.default_rng(1234)
            hint = torch.as_tensor(x0_hint, dtype=torch.float64).cpu().numpy().reshape(-1)
            x0p = np.clip(hint + rng.uniform(-0.1, 1.0, mop.n_vars), mop.lb, mop.ub)
            J = np.vstack([g.jac_unscaled(self._tensor(x0p)).cpu().numpy()
                           for g in mop.groups])
            self.scal = scaling.estimate_auto_scaler(J, lb, ub, dtype, self.device)
        else:
            self.scal = scaling.get_var_scaler(self._tensor(mop.lb),
                                               self._tensor(mop.ub), ac.var_scaler)
        # the largest per-rebuild working set of any group (n+1 without a
        # modelled group), and the most new sites one iteration may add: a
        # Taylor stencil on every move, up to p poised points for Lagrange
        # (JAX algorithm.py:308-330; without the second term those
        # overflow the database)
        max_model_pts = max([g.cfg.resolved_max_points(mop.n_vars)
                             for g in mop.groups
                             if hasattr(g.cfg, "resolved_max_points")],
                            default=mop.n_vars + 1)
        sites_per_iter = max([g.cfg.resolved_max_points(mop.n_vars) for g in mop.groups
                              if isinstance(g.cfg, (TaylorConfig, LagrangeConfig))],
                             default=0)
        #: (max_model_points, sites_per_iter): the inputs of
        #: resolved_db_capacity besides the config, kept so that the staged
        #: runner can evaluate it at intermediate iteration bounds
        self._cap_terms = (max_model_pts, sites_per_iter)
        self.db_capacity = ac.resolved_db_capacity(mop.n_vars, *self._cap_terms)
        self.container = SurrogateContainer(mop, dtype, ac, self.db_capacity,
                                            self.device)
        self.container.log = self._log
        self.desc_cfg = resolve_descent_config(ac.descent_method)
        self.T = ac.resolved_trajectory_capacity()
        #: width of the per-iteration training-set stamp (save_model_meta)
        self.MW = self.container.train_stamp_len if ac.save_model_meta else 0
        # without nonlinear constraints the filter is the reference's
        # DummyFilter (zero capacity, accepts everything)
        self.filter_mode = "dummy" if mop.m_ce + mop.m_ci == 0 else ac.filter_type
        self.f_dim = mop.m_obj if self.filter_mode == "strict" else 1
        self.has_constraints = mop.has_nl_constraints or mop.has_lin_constraints
        # the constant problem data on the device once: a host-to-device
        # copy inside a trip would wait for the queued kernels
        self._lb, self._ub = self._tensor(mop.lb), self._tensor(mop.ub)
        self._A_eq, self._b_eq = self._tensor(mop.A_eq), self._tensor(mop.b_eq)
        self._A_ineq, self._b_ineq = self._tensor(mop.A_ineq), self._tensor(mop.b_ineq)
        #: iterations of the restoration loop since the counter was last set
        #: to 0 (one per masked trip over the lanes, on the host)
        self.restoration_iterations = 0
        self._ps_consts = None
        #: any host (NumPy) function: true evaluations are masked per lane
        self._any_host = any(f.host for g in mop.groups for f in g.fns)

    # ------------------------------------------------------------------ helpers
    def _tensor(self, v, dtype=None):
        return torch.as_tensor(v, dtype=dtype or self.dtype, device=self.device)

    def _violation_zero(self, theta):
        """``constraint_violation_is_zero`` (``utilities.jl:335-342``)."""
        return theta.abs() <= 10 * torch.finfo(self.dtype).eps

    def _lin_matrices(self, scal):
        """Linear constraints in the scaled space of ``scal``, per lane
        (``transformed_linear_constraints``, ``AbstractMOPInterface.jl:476``):
        (A_eq_s (B, p, n), b_eq_s (B, p), A_ineq_s, b_ineq_s)."""
        inv_s = (1.0 / scal.scale)[:, None, :]
        A_eq_s = self._A_eq * inv_s
        b_eq_s = self._b_eq + _mv(A_eq_s, scal.offset)
        A_ineq_s = self._A_ineq * inv_s
        b_ineq_s = self._b_ineq + _mv(A_ineq_s, scal.offset)
        return A_eq_s, b_eq_s, A_ineq_s, b_ineq_s

    def _linear_values(self, x_s, scal):
        A_eq_s, b_eq_s, A_ineq_s, b_ineq_s = self._lin_matrices(scal)
        return _mv(A_eq_s, x_s) - b_eq_s, _mv(A_ineq_s, x_s) - b_ineq_s

    def _theta(self, st: "SolverState"):
        return flt.compute_constraint_val(st.l_e, st.l_i, st.c_e, st.c_i)

    def _filter_objective(self, fx):
        return flt.compute_objective_val(
            fx, "max" if self.filter_mode in ("max", "dummy") else "strict")

    def _stamp(self, traj: TrajectoryState, x, fx, delta, rho, omega,
               steplength, it_stat, x_indices, groups) -> TrajectoryState:
        B, T, _ = traj.data.shape
        dt = traj.data.dtype
        col = lambda v: torch.as_tensor(v, dtype=dt, device=self.device).expand(B)[:, None]
        parts = [x.to(dt), fx.to(dt), col(delta), col(rho), col(omega),
                 col(steplength), col(it_stat), x_indices.to(dt)]
        if self.MW:
            parts.append(self.container.train_stamps(groups).to(dt))
        row = torch.cat(parts, dim=-1)
        slot = torch.clamp(traj.count, 0, T - 1)
        hit = ((torch.arange(T, device=self.device) == slot[:, None])
               & (traj.count < T)[:, None])
        data = torch.where(hit[..., None], row[:, None, :], traj.data)
        return dataclasses.replace(traj, data=data, count=traj.count + 1)

    def _total_evals(self, groups):
        return sum(st.n_evals for st in groups)

    # -------------------------------------------------- criticality computation
    def _linearized_constraints_at(self, groups, x_s, x_n_s, l_e_n, l_i_n, scal):
        """Rows for the subproblem LPs at x+n (``descent.jl:199-236``): the
        true linear constraints with right-hand side -l(x_n), and the
        surrogate linearizations of the nonlinear ones around x, shifted to
        x_n; each block row-equilibrated."""
        n_step = x_n_s - x_s
        A_eq_s, _, A_ineq_s, _ = self._lin_matrices(scal)
        parts_Ae, parts_be = [A_eq_s], [-l_e_n]
        parts_Ai, parts_bi = [A_ineq_s], [-l_i_n]
        if self.mop.m_ce > 0:
            Dm_e = self.container.jac_nl_eq(groups, x_s, scal)
            m_e, _ = self.container.eval_nl_eq(groups, x_n_s, scal)
            parts_Ae.append(Dm_e)
            parts_be.append(-m_e - _mv(Dm_e, n_step))
        if self.mop.m_ci > 0:
            Dm_i = self.container.jac_nl_ineq(groups, x_s, scal)
            m_i, _ = self.container.eval_nl_ineq(groups, x_n_s, scal)
            parts_Ai.append(Dm_i)
            parts_bi.append(-m_i - _mv(Dm_i, n_step))

        def equilibrate(rows, rhs):
            # row equilibration (a mathematical no-op), as OSQP scales its
            # data: rows far from unit inf-norm stall the fixed-budget ADMM
            # (the JAX package's note at algorithm.py:446-455)
            r = rows.abs().amax(-1)
            r = torch.where(r > 0, r, torch.ones_like(r))
            return rows / r[..., None], rhs / r

        A_eq, b_eq = equilibrate(torch.cat(parts_Ae, dim=-2), torch.cat(parts_be, dim=-1))
        A_ineq, b_ineq = equilibrate(torch.cat(parts_Ai, dim=-2),
                                     torch.cat(parts_bi, dim=-1))
        return LinearizedConstraints(A_eq=A_eq, b_eq=b_eq, A_ineq=A_ineq, b_ineq=b_ineq)

    def _get_criticality(self, groups, x_s, x_n_s, l_e_n, l_i_n, fx_n, delta, scal):
        """``get_criticality`` (``descent.jl:19-25``): ``(omega, payload,
        groups)``, the payload the descent direction of steepest descent
        (whose LP reads model Jacobians only and charges nothing) or the
        Pascoletti-Serafini trial point."""
        if not isinstance(self.desc_cfg, SteepestDescentConfig):
            return self._ps_criticality(groups, x_s, x_n_s, fx_n, delta, scal)
        Dm = self.container.jac_objectives(groups, x_n_s, scal)
        lin = self._linearized_constraints_at(groups, x_s, x_n_s, l_e_n, l_i_n, scal)
        d, omega = steepest_descent_direction(
            x_n_s, Dm, scal.lb_scaled, scal.ub_scaled, lin,
            normalize=self.desc_cfg.normalize, qp_iters=self.ac.qp_iters,
            qp_exit_eps=self.ac.qp_exit_eps)
        return omega, d, groups

    def _ps_criticality(self, groups, x_s, x_n_s, fx_n, delta, scal):
        """Pascoletti-Serafini descent (``descent.jl:512-581``), as the JAX
        package computes it: ``min t s.t. m(chi) <= m(x_n) + t r`` over each
        lane's local box, the constraints as a quadratic penalty. The NLopt
        stages are a Halton sweep (with x_n as an extra start) and
        optional projected gradient polish of the penalized scalarization
        (:func:`maximize_in_box`). ``r`` is the reference direction, the
        distance to the reference point, or else to the local ideal point
        (one sweep per objective). Returns ``(omega = |t*|, x_trial,
        groups)``; a critical, infeasible or non-finite result keeps x_n
        with omega 0. Exact groups are charged the budgeted scalarization
        evaluations (``ps_subsolver_budgets``): the reference's NLopt
        objective is the container, whose exact models count."""
        cfg, dtype, mop, container = self.desc_cfg, self.dtype, self.mop, self.container
        n = mop.n_vars
        lb_eff = torch.maximum(scal.lb_scaled, x_s - delta[:, None])
        ub_eff = torch.minimum(scal.ub_scaled, x_s + delta[:, None])
        A_eq_s, b_eq_s, A_ineq_s, b_ineq_s = self._lin_matrices(scal)
        ps_grid_n, ps_polish, id_grid_n, id_polish = ps_subsolver_budgets(cfg, n)
        grid, ideal_grid, r_const = self._ps_constants()
        sq = lambda v: (v * v).sum(-1)

        def penalty(chi):
            """(B, K) constraint penalty at sites ``chi (B, K, n)``."""
            pen = torch.zeros(chi.shape[:-1], dtype=dtype, device=chi.device)
            if mop.m_ce > 0:
                pen = pen + sq(container.eval_nl_eq_raw(groups, chi, scal))
            if mop.m_ci > 0:
                pen = pen + sq(torch.clamp(container.eval_nl_ineq_raw(groups, chi, scal),
                                           min=0.0))
            if mop.A_eq.shape[0]:
                pen = pen + sq(lane_product(chi, A_eq_s.transpose(-1, -2))
                               - b_eq_s[:, None, :])
            if mop.A_ineq.shape[0]:
                pen = pen + sq(torch.clamp(lane_product(chi, A_ineq_s.transpose(-1, -2))
                                           - b_ineq_s[:, None, :], min=0.0))
            return pen

        PEN_W = 1e5
        objectives = lambda chi: container.eval_objectives_raw(groups, chi, scal)
        charged = ps_grid_n + ps_polish
        if len(cfg.reference_direction):
            r = r_const.expand_as(fx_n)
        elif len(cfg.reference_point):
            r = fx_n - r_const
        else:
            # local ideal point (``descent.jl:404-412``)
            charged += mop.m_obj * (id_grid_n + id_polish)
            ideals = []
            for l in range(mop.m_obj):
                f_l = lambda chi, l=l: -(objectives(chi)[..., l] + PEN_W * penalty(chi))
                _, v = maximize_in_box(f_l, lb_eff, ub_eff, ideal_grid, iters=id_polish)
                ideals.append(-v)
            r = fx_n - torch.stack(ideals, dim=-1)

        mx = objectives(x_n_s)

        def t_pure(chi):
            return ((objectives(chi) - mx[:, None, :]) / r[:, None, :]).amax(-1)

        t_pen = lambda chi: -(t_pure(chi) + PEN_W * penalty(chi))
        x_best, _ = maximize_in_box(t_pen, lb_eff, ub_eff, grid, iters=ps_polish,
                                    extra_starts=x_n_s[:, None, :])
        tau = torch.clamp(t_pure(x_best[:, None, :])[:, 0], -1.0, 0.0)
        feasible = penalty(x_best[:, None, :])[:, 0] <= 1e-8
        bad = (r <= 0).any(-1) | ~feasible | ~torch.isfinite(x_best).all(-1)
        x_trial = lane_where(bad, x_n_s, x_best)
        omega = torch.where(bad, torch.zeros_like(tau), tau.abs())
        groups = container.charge_evals(
            groups, torch.full_like(omega, charged, dtype=torch.int32))
        return omega, x_trial, groups

    def _ps_constants(self):
        """The PS sweep and ideal-point grids and the reference vector on
        the device, made once."""
        if self._ps_consts is None:
            cfg, n = self.desc_cfg, self.mop.n_vars
            ps_grid_n, _, id_grid_n, _ = ps_subsolver_budgets(cfg, n)
            grid = self._tensor(halton_grid(ps_grid_n, n))
            ideal = grid if id_grid_n == ps_grid_n else self._tensor(halton_grid(id_grid_n, n))
            ref = cfg.reference_direction if len(cfg.reference_direction) else cfg.reference_point
            self._ps_consts = (grid, ideal, self._tensor(ref) if len(ref) else None)
        return self._ps_consts

    # ------------------------------------------------------------- initialization
    def _ingest(self, groups, populated_db, scal):
        """The databases of ``populated_db`` (a previous ``OptimizeResult``,
        ``SolverState`` or tuple of group states, with a lane axis of B or
        1, or none as ``optimize`` returns them) in place of the fresh ones,
        re-transformed to the current scaler lane by lane
        (``algorithm.jl:286-297``, ``Databases.jl:300``). A lane whose
        previous scaler equals the current one keeps its stored sites bit
        for bit (the round trip is not a float identity, and
        ``ensure_evaluated`` matches recycled rows by exact site equality);
        raw group tuples carry no scaler and are taken as they are."""
        prev, prev_scal = populated_db, None
        if isinstance(prev, OptimizeResult):
            prev = prev.state
        if isinstance(prev, SolverState):
            prev_scal, prev = prev.scal, prev.groups
        B = scal.scale.shape[0]

        def lanes(t, lead):
            t = t.to(self.device)
            t = t[None] if t.dim() == lead else t
            return t.expand((B,) + t.shape[1:]).contiguous()

        out = []
        for fresh, old in zip(groups, prev):
            db = old.db
            data = lanes(db.data, 2).to(self.dtype)
            db = dbm.Database(data=data, count=lanes(db.count, 0).to(torch.int32),
                              overflow=lanes(db.overflow, 0), n=db.n, m=db.m)
            if prev_scal is not None:
                ps = scaling.VarScaler(*(lanes(f, 1).to(self.dtype) for f in prev_scal))
                new = dbm.rescale(db, ps.scale, ps.offset, scal.scale, scal.offset)
                same = ((ps.scale == scal.scale).all(-1)
                        & (ps.offset == scal.offset).all(-1))
                db = dataclasses.replace(db, data=lane_where(same, db.data, new.data))
            out.append(fresh._replace(db=db))
        return tuple(out)

    def _bind(self, theta: tuple) -> None:
        """Bind a parametric problem's per-lane ``theta`` for the
        evaluations that follow (``core/parametric.py``)."""
        if self.mop.lanes is not None:
            if not theta:
                raise ValueError("a parametric problem needs its theta: solve it "
                                 "with parametric_multistart")
            self.mop.lanes.bind(theta)

    @_full_precision_matmuls()
    def initialize(self, x0, populated_db=None, theta: tuple = ()) -> SolverState:
        """``initialize_data`` (``algorithm.jl:223-323``) for a (B, n) batch
        of starting points (a single (n,) start is the batch of one).
        ``theta``: a parametric problem's per-lane data, its leaves with the
        lane axis first, on the solver's device.

        ``populated_db`` recycles the evaluation databases of a previous
        run on the same problem, lane by lane (the reference's
        ``optimize(...; populated_db)`` checkpoint/resume path,
        ``algorithm.jl:286-297``; see :meth:`_ingest`). Evaluation counters
        reset and the models are rebuilt."""
        mop, dtype, dev = self.mop, self.dtype, self.device
        x0 = self._tensor(x0)
        if x0.dim() == 1:
            x0 = x0[None]
        B, n = x0.shape
        self._bind(theta)
        x = project_into_box(x0, self._lb, self._ub)
        scal = scaling.VarScaler(*(f.expand(B, n).contiguous() for f in self.scal))
        x_s = scaling.transform(scal, x)

        groups = self.container.init_group_states(B)
        if populated_db is not None:
            groups = self._ingest(groups, populated_db, scal)
        fx, c_e, c_i, groups, x_indices = self.container.ensure_evaluated(groups, x_s,
                                                                          scal)
        l_e, l_i = self._linear_values(x_s, scal)
        delta0 = torch.full((B,), self.ac.delta_0, dtype=dtype, device=dev)

        G = len(mop.groups)
        traj = TrajectoryState(
            data=torch.zeros((B, self.T, n + mop.m_obj + 5 + G + self.MW),
                             dtype=dtype, device=dev),
            count=torch.zeros((B,), dtype=torch.int32, device=dev),
            n=n, m=mop.m_obj, G=G, MW=self.MW)
        ninf = -float("inf")
        traj = self._stamp(traj, x, fx, delta0, ninf, ninf, ninf,
                           int(ITER_TYPE.INITIALIZATION), x_indices, groups)
        # initial surrogates (``init_surrogates``)
        groups = self.container.update(groups, x_s, x_indices, delta0,
                                       ensure_fully_linear=True, scal=scal)
        head = torch.tensor([1, ITER_TYPE.ACCEPTABLE, STOP_CODE.CONTINUE,
                             _MODE_NORMAL, 0], dtype=torch.int32, device=dev)
        ints = torch.cat([head.expand(B, 5), x_indices.to(torch.int32)], dim=-1)
        # the dummy filter carries no buffers
        cap = 0 if self.filter_mode == "dummy" else self.ac.resolved_filter_capacity()
        if self._log is not None:
            self._log.flush()
        return SolverState(
            x=x, x_s=x_s, fx=fx, l_e=l_e, l_i=l_i, c_e=c_e, c_i=c_i,
            dlt=torch.stack([delta0, delta0], dim=-1), ints=ints, groups=groups,
            filter=flt.init_filter(B, cap, self.f_dim, dtype, dev), traj=traj,
            scal=scal, key=self._initial_key(x_s) if self.container.draws else None,
            theta=tuple(theta))

    @staticmethod
    def _initial_key(x_s):
        """Each lane's key, ``fold_in(PRNGKey(1234), uint32(sum |x_s 1e6|))``
        as the JAX package seeds it (algorithm.py:669-671): the sum in the
        solver's dtype in index order, XLA's saturating conversion."""
        v = (x_s * 1e6).abs()
        total = v[:, 0]
        for j in range(1, v.shape[-1]):
            total = total + v[:, j]
        return prng.fold_in(prng.prng_key(1234, x_s.device),
                            prng.float_to_uint32(total))

    # ------------------------------------------------------------------ stopping
    def _tol_tests(self, x, x_t, fx, fx_t):
        """Relative/absolute x/f stopping tests (``algorithm.jl:14-56``);
        scalar tolerances test inf-norms, vector ones componentwise."""
        ac = self.ac
        inf_norm = lambda v: (v.abs().amax(-1) if v.shape[-1]
                              else torch.zeros(v.shape[:-1], dtype=v.dtype,
                                               device=v.device))

        def rel(test_v, ref_v, tol):
            if np.isscalar(tol):
                return inf_norm(test_v) <= tol * inf_norm(ref_v)
            return (test_v.abs() <= self._tensor(tol) * ref_v).all(-1)

        def absolute(test_v, tol):
            if np.isscalar(tol):
                return inf_norm(test_v) <= tol
            return (test_v.abs() <= self._tensor(tol)).all(-1)

        fr = rel(fx - fx_t, fx, ac.f_tol_rel)
        # vector x_tol_rel is componentwise absolute in the reference
        # (``algorithm.jl:30``)
        xr = (rel(x - x_t, x, ac.x_tol_rel) if np.isscalar(ac.x_tol_rel)
              else absolute(x - x_t, ac.x_tol_rel))
        fa = absolute(fx - fx_t, ac.f_tol_abs)
        xa = absolute(x - x_t, ac.x_tol_abs)
        return fr | xr | fa | xa

    def _omega_tests(self, omega, delta):
        """``ω_Δ_rel_test`` + ``ω_abs_test`` (``algorithm.jl:58-78``)."""
        ac = self.ac
        rel = (omega <= ac.omega_tol_rel) & (delta <= ac.delta_tol_rel)
        return rel | (omega <= ac.omega_tol_abs)

    def _apply_radius_update(self, code, delta, steplength):
        """``do_radius_update`` (``algorithm.jl:140-196``)."""
        ac = self.ac
        if ac.radius_update_method == "standard":
            grow = torch.clamp(ac.gamma_grow * delta, max=ac.delta_max)
            shrink = delta * ac.gamma_shrink
            shrink_much = delta * ac.gamma_shrink_much
        else:  # 'steplength'
            grow = torch.clamp((ac.gamma_grow + steplength / delta) * delta,
                               max=ac.delta_max)
            shrink = steplength * ac.gamma_shrink
            shrink_much = steplength * ac.gamma_shrink_much
        RU = RADIUS_UPDATE
        return torch.where(code == RU.GROW, grow,
                           torch.where(code == RU.SHRINK, shrink,
                                       torch.where(code == RU.SHRINK_MUCH,
                                                   shrink_much, delta)))

    # ------------------------------------------------------------ one iteration
    @_full_precision_matmuls()
    def iterate(self, state: SolverState) -> SolverState:
        """``iterate!`` (``algorithm.jl:615-917``) for every lane.

        One outer trip is either a NORMAL iteration or ONE criticality
        micro-step (``crit_mode > 0``); micro trips do not advance the
        iteration counter or stamp the trajectory."""
        self._check_device(state)
        self._bind(state.theta)
        ac = self.ac
        SC = STOP_CODE
        stop = torch.where(
            state.iter_counter > ac.max_iter, SC.MAX_ITER,
            torch.where(self.container.budget_exhausted(state.groups),
                        SC.BUDGET_EXHAUSTED,
                        torch.where(state.delta <= ac.delta_tol_abs,
                                    SC.TOLERANCE, SC.CONTINUE)))
        stop = torch.where(state.crit_mode > _MODE_NORMAL, SC.CONTINUE, stop)
        go = stop == SC.CONTINUE
        # host groups: the lanes whose trip is kept (a lane that stopped may
        # pass the tests above again; the solve loops keep its state)
        keep = go & (state.stop_code == SC.CONTINUE) if self._any_host else None
        out = tree_where(go, self._iterate_inner(state, go, keep),
                         state.replace(stop_code=stop))
        if self._log is not None:
            self._log.flush(go)
        return out

    def _keep(self, keep, drop):
        """The lanes of ``keep`` without those of ``drop`` (None without a
        host function: no mask is formed)."""
        return None if keep is None else keep & ~drop

    def _check_device(self, state: SolverState) -> None:
        """Raise unless every tensor of ``state`` lies on the solver's
        device: the kernels' wrappers route by the device of the tensors
        they are given, so a state elsewhere would not run the kernels."""
        want, seen = self.device, set()
        tree_map(lambda t: seen.add(t.device) or t, state)
        bad = sorted(str(d) for d in seen if d.type != want.type
                     or (want.index is not None and d.index != want.index))
        if bad:
            raise ValueError(
                f"the state lies on {', '.join(bad)} and the solver on {want}; "
                "move it with utils.tree.tree_map(lambda t: t.to(device), state)")

    def _rescale_model(self, state: SolverState, gate) -> SolverState:
        """The ``'model'`` scaler update (``new_var_scaler``,
        ``VarScaler.jl:240-260``; ``algorithm.jl:661-679``) on the lanes of
        ``gate``: new factors from the surrogates' Jacobians, the databases'
        valid rows, the scaled iterate and the linear rows re-transformed.
        The other lanes keep their state."""
        old = state.scal
        # Jf ~ Jm * d(transform)/dx = Jm diag(scale_old)
        J = self.container.jac_all(state.groups, state.x_s, old) * old.scale[:, None, :]
        bounded = np.isfinite(self.mop.lb) & np.isfinite(self.mop.ub)
        new = scaling.estimate_linear_scaling_traced(J, self._lb, self._ub, bounded)
        groups = tuple(st._replace(db=tree_where(gate, dbm.rescale(
            st.db, old.scale, old.offset, new.scale, new.offset), st.db))
            for st in state.groups)
        scal = scaling.VarScaler(*(lane_where(gate, a, b) for a, b in zip(new, old)))
        x_s = lane_where(gate, scaling.transform(new, state.x), state.x_s)
        l_e, l_i = self._linear_values(x_s, scal)
        return state.replace(groups=groups, x_s=x_s, scal=scal,
                             l_e=lane_where(gate, l_e, state.l_e),
                             l_i=lane_where(gate, l_i, state.l_i))

    def _compact_databases(self, state: SolverState, in_crit) -> SolverState:
        """``use_db=False``: every database keeps only its current iterate's
        row, moved to row 0 (``MockDB``, ``Databases.jl:11-32``), once per
        iteration; criticality micro-trips keep the working set their
        iteration compacted to."""
        groups = tuple(st._replace(db=tree_where(
            in_crit, st.db, dbm.compact_to_row(st.db, state.x_indices[:, i])))
            for i, st in enumerate(state.groups))
        x_idx = state.x_indices
        x_idx = torch.where(in_crit[:, None], x_idx,
                            torch.where(x_idx >= 0, 0, -1).to(x_idx.dtype))
        return state.replace(groups=groups, x_indices=x_idx)

    def _iterate_inner(self, state: SolverState, go, keep=None) -> SolverState:
        ac = self.ac
        in_crit = state.crit_mode > _MODE_NORMAL
        looping = state.crit_mode == _MODE_CRIT_LOOP
        if self._log is not None:
            self._log.add(3, "| Iteration {i}: delta={d:.3e} evals={e} crit_mode={m} "
                          "x={x} f={f}", i=state.iter_counter, d=state.delta,
                          e=self._total_evals(state.groups), m=state.crit_mode,
                          x=state.x, f=state.fx)
        # per-iteration scaler update, never mid-criticality (the routine
        # sees one fixed scaling)
        if ac.var_scaler_update == "model":
            state = self._rescale_model(state, (state.iter_counter > 1) & ~in_crit)
        if not ac.use_db:
            state = self._compact_databases(state, in_crit)
        # per-pass halt check of the criticality routine
        # (``algorithm.jl:563-573``): evaluated BEFORE the rebuild
        crit_halt = looping & (
            (state.crit_nloops >= ac.max_critical_loops)
            | self.container.budget_exhausted(state.groups))
        # criticality fixpoint certificate inputs: db fill + eval counters
        # BEFORE this trip's pass
        pre_stats = tuple((st.db.count, st.n_evals) for st in state.groups)

        # surrogate update (``algorithm.jl:682-688``), shared by normal
        # update-vs-improve and criticality rebuild passes
        improve_flag = (~in_crit) & (state.last_it_stat == ITER_TYPE.MODELIMPROVING)
        do_update = torch.where(in_crit, ~crit_halt, state.iter_counter > 1)
        key = None
        if self.container.draws:
            # the pass's key: fold_in(key, iter_counter), in criticality
            # fold_in(key, 7001 + crit_nloops) (JAX algorithm.py:840-843)
            if state.key is None:
                raise ValueError("a state without a PRNG key for a problem whose "
                                 "RBF group has use_max_points")
            key = prng.fold_in(state.key, torch.where(in_crit, 7001 + state.crit_nloops,
                                                      state.iter_counter))
        upd = self.container.update_or_improve(
            state.groups, state.x_s, state.x_indices, state.delta,
            improve_flag, scal=state.scal, efl_flag=in_crit,
            active=(go if keep is None else keep) & do_update, key=key, log_when=do_update)
        state = state.replace(groups=tree_where(do_update, upd, state.groups))

        theta_k = self._theta(state)
        if self.has_constraints:
            return self._constrained_phase(state, theta_k, crit_halt, pre_stats, keep)
        return self._main_phase(state, state, theta_k, theta_k, crit_halt,
                                pre_stats, keep)

    # ---------------------------------------------------------------- phase A
    def _constrained_phase(self, state: SolverState, theta_k, crit_halt,
                           pre_stats, keep=None) -> SolverState:
        """Normal step / restoration dispatch (``find_normal_step``,
        ``algorithm.jl:406-521``). Each lane takes one of three outcomes:
        the main phase (from x or from x+n), restoration, or an INFEASIBLE
        finish; each is computed for every lane and selected per lane, as
        the JAX package's vmapped conds do, and skipped on a trip where no
        lane takes it (one host check each)."""
        ac = self.ac
        scal = state.scal
        need_normal = ~self._violation_zero(theta_k)
        if not bool(need_normal.any()):
            if self._log is not None:
                yes = torch.ones_like(need_normal)
                self._log_normal_step(need_normal, torch.zeros_like(theta_k), yes, yes)
                self._log_restoration_skipped(state, torch.zeros_like(state.x_s))
            return self._main_phase(state, state, theta_k, theta_k, crit_halt, pre_stats,
                                    keep)

        # the normal-step LP (``compute_normal_step``), solved for every
        # lane and taken where a lane needs it (JAX: a 0/1-trip while_loop)
        lin = self._linearized_constraints_at(state.groups, state.x_s, state.x_s,
                                              state.l_e, state.l_i, scal)
        variable_radius = state.last_it_stat == ITER_TYPE.RESTORATION
        n_raw, delta_raw, feas_raw = normal_step(
            state.x_s, scal.lb_scaled, scal.ub_scaled, lin, ac.filter_kappa_delta,
            ac.delta_max, state.delta, variable_radius, qp_iters=ac.qp_iters,
            qp_exit_eps=ac.qp_exit_eps)
        n_step = lane_where(need_normal, n_raw, torch.zeros_like(n_raw))
        delta_n = torch.where(need_normal, delta_raw, state.delta)
        feasible = torch.where(need_normal, feas_raw, torch.ones_like(feas_raw))

        # compatibility test (``is_compatible``, ``algorithm.jl:131-137``)
        inf = torch.full_like(n_step, float("inf"))
        norm_n = torch.where(torch.isnan(n_step), inf, n_step).abs().amax(-1)
        compatible = feasible & (
            norm_n <= ac.filter_kappa_delta * delta_n
            * torch.clamp(ac.filter_kappa_mu * delta_n ** ac.filter_mu, max=1.0))
        take_n = need_normal & compatible
        if self._log is not None:
            self._log_normal_step(need_normal, norm_n, feasible, compatible)
            # JAX's run prints the restoration line before the main phase's
            self._restoration_mark = self._log.mark()

        # the bundle at x+n (``:461-514``), selected per lane against x's
        changed = take_n & ~torch.isclose(delta_n, state.delta)
        groups2 = tree_where(changed, self.container.set_fully_linear(state.groups, False),
                             state.groups)
        step = torch.where(take_n[:, None], torch.nan_to_num(n_step),
                           torch.zeros_like(n_step))
        x_n_s = state.x_s + step
        fx_n, c_e_n, c_i_n, groups3, idx_n = self._gated_evaluate_true(
            groups2, x_n_s, scal, None if keep is None else keep & take_n)
        l_e_n, l_i_n = self._linear_values(x_n_s, scal)
        state_b = state.replace(groups=groups3,
                                delta=torch.where(changed, delta_n, state.delta))
        inter_b = state_b.replace(
            x=scaling.untransform(scal, x_n_s), x_s=x_n_s, fx=fx_n, l_e=l_e_n,
            l_i=l_i_n, c_e=c_e_n, c_i=c_i_n, x_indices=idx_n)
        theta_sel = torch.where(take_n, self._theta(inter_b), theta_k)
        incompatible = need_normal & ~compatible
        out_main = self._main_phase(tree_where(take_n, state_b, state),
                                    tree_where(take_n, inter_b, state), theta_k,
                                    theta_sel, crit_halt, pre_stats,
                                    self._keep(keep, incompatible))

        # incompatible lanes: restoration or INFEASIBLE (``:440-493``)
        if not bool(incompatible.any()):
            if self._log is not None:
                self._log_restoration_skipped(state, n_step, self._restoration_mark)
            return out_main
        out_other = self._incompatible_path(
            state, theta_k, n_step, feasible,
            incompatible if keep is None else incompatible & keep, keep)
        return tree_where(incompatible, out_other, out_main)

    def _log_normal_step(self, needed, norm_n, feasible, compatible):
        """The live log's normal-step line (JAX algorithm.py:912-919),
        printed every trip of a constrained problem."""
        self._log.add(4, "|  Normal step: needed={d} |n|={n:.3e} feasible={f} "
                      "compatible={c}", d=needed, n=norm_n, f=feasible, c=compatible)

    def _log_restoration_skipped(self, state, r_guess, at=None):
        """The restoration line of a trip on which no lane restores: JAX's
        run reaches its restoration on every trip that does not follow one
        (algorithm.py:1244-1250), with no iteration and theta at the start
        point (inf for host functions, whose pass is gated off)."""
        if not self.mop.has_nl_constraints:
            return
        xi = self._restoration_start(state, r_guess)
        if self._any_host:
            theta = torch.full_like(state.delta, float("inf"))
        else:
            theta = flt.compute_constraint_val(*self._true_constraints(xi, False))
        zero = torch.zeros_like(state.crit_mode)
        self._log.add(4, "|  Restoration: active={a} iters={i} theta_r={t:.3e}",
                      state.last_it_stat != ITER_TYPE.RESTORATION, at,
                      a=zero > 0, i=zero, t=theta)

    def _restoration_start(self, state, r_guess):
        """Restoration's start point: x plus the normal step's guess (none
        where it is NaN), in the box."""
        bad = torch.isnan(r_guess).any(-1, keepdim=True)
        r0 = torch.where(bad, torch.zeros_like(state.x), torch.nan_to_num(r_guess)
                         / torch.clamp(state.scal.scale, min=1e-30))
        return project_into_box(state.x + r0, self._lb, self._ub)

    def _gated_evaluate_true(self, groups, x_s, scal, active):
        """``container.evaluate_true`` at a candidate whose results a lane
        may discard: host groups are called at the lanes of ``active`` only
        (the JAX package's gated evaluation, algorithm.py:955-975; None
        evaluates every lane, as for torch groups always)."""
        return self.container.evaluate_true(groups, x_s, scal, active)

    def _incompatible_path(self, state: SolverState, theta_k, n_step, feasible,
                           active, keep=None) -> SolverState:
        """Restoration, or INFEASIBLE right after a restoration
        (``algorithm.jl:440-452``). With ``keep`` (host functions), host
        groups evaluate only the lanes whose result is kept."""
        last_restoration = state.last_it_stat == ITER_TYPE.RESTORATION
        infeasible = self._finish_early(state, STOP_CODE.INFEASIBLE)
        if self.mop.has_nl_constraints:
            restored = self._restoration(state, theta_k, n_step,
                                         active & ~last_restoration)
            return tree_where(last_restoration, infeasible, restored)
        # linearly constrained only: n itself restores (``:447-452``)
        n_ok = feasible & torch.isfinite(n_step).all(-1)
        scal = state.scal
        x_n_s = state.x_s + torch.nan_to_num(n_step)
        take = n_ok & ~last_restoration
        fx_n, c_e_n, c_i_n, groups, idx_n = self._gated_evaluate_true(
            state.groups, x_n_s, scal, None if keep is None else active & take)
        l_e_n, l_i_n = self._linear_values(x_n_s, scal)
        restored = self._finish_restoration(state.replace(
            x=scaling.untransform(scal, x_n_s), x_s=x_n_s, fx=fx_n, l_e=l_e_n,
            l_i=l_i_n, c_e=c_e_n, c_i=c_i_n, groups=groups, x_indices=idx_n))
        return tree_where(take, restored, infeasible)

    def _true_constraints(self, xi, want_jac: bool, mask=None):
        """True constraint blocks (l_e, l_i, c_e, c_i) at unscaled sites
        ``xi`` (B, n), evaluating only the groups that feed nonlinear
        constraints, directly or through a composite (``algorithm.jl:355-362``:
        restoration never touches objective-only groups); with ``want_jac``
        also (J_e, J_i), a composite's rows by the chain rule
        ``D_x phi + D_g phi J_inner``. ``mask`` (B,): the lanes at which
        host groups are called (their values, and finite-difference
        Jacobians, zero elsewhere)."""
        mop, con = self.mop, (NL_EQ, NL_INEQ)
        need = {cs.group_index for cs in mop.composites if cs.role in con}
        vals, jacs = [], []
        for g in mop.groups:
            use = g.index in need or any(mb.role in con for mb in g.members)
            host = use and g.any_host
            vals.append(None if not use else g.eval_unscaled_batch_masked(
                xi, mask, kind="restoration") if host else g.eval_unscaled(xi))
            jacs.append(None if not (use and want_jac) else g.jac_unscaled(xi, mask)
                        if host else g.jac_unscaled(xi))
        comp_v, comp_J = [], []
        for cs in mop.composites:
            if cs.role not in con:
                comp_v.append(None)
                comp_J.append(None)
                continue
            inner = cs.inner(vals[cs.group_index])
            comp_v.append(cs.eval(xi, inner))
            if want_jac:
                d_x, d_g = cs.partials(xi, inner)
                J_in = jacs[cs.group_index][..., cs.group_offset:cs.group_offset + cs.width, :]
                comp_J.append(chain_rule(d_x, d_g, J_in))
        blocks = (_mv(self._A_eq, xi) - self._b_eq, _mv(self._A_ineq, xi) - self._b_ineq,
                  self._role(vals, NL_EQ, xi, -1, comp_v),
                  self._role(vals, NL_INEQ, xi, -1, comp_v))
        if not want_jac:
            return blocks
        return blocks, (self._role(jacs, NL_EQ, xi, -2, comp_J),
                        self._role(jacs, NL_INEQ, xi, -2, comp_J))

    def _role(self, group_values, role, xi, axis, composite_values=None):
        """``mop.scatter_role`` that also takes a role nobody serves."""
        if self.mop.role_width(role) == 0:
            shape = (xi.shape[0], 0) if axis == -1 else (xi.shape[0], 0, xi.shape[-1])
            return xi.new_zeros(shape)
        return self.mop.scatter_role(group_values, role, axis, composite_values)

    def _restoration(self, state: SolverState, theta_k, r_guess, active) -> SolverState:
        """Nonlinear restoration (``restoration``, ``algorithm.jl:325-404``)
        as the JAX package computes it: projected gradient descent with step
        halving on the squared-hinge violation of the true constraints, from
        x plus the normal step's guess; the reference's eval budget, its
        ``stopval`` exit at theta zero and its counting. The filter takes the
        current iterate first (``:470-471``). ``active`` (B,) marks the lanes
        that restore; the others run no iteration. Each lane has its own
        iteration cap and done flag; the loop runs, masked, until no lane is
        active, checking on the host once in ``RESTORATION_SYNC_EVERY``
        iterations."""
        ac, dtype, mop = self.ac, self.dtype, self.mop
        state = state.replace(filter=flt.add_entry(
            state.filter, theta_k, self._filter_objective(state.fx), ac.filter_shift))
        lb, ub, A_eq, A_ineq = self._lb, self._ub, self._A_eq, self._A_ineq
        x = state.x
        pos = lambda v: torch.clamp(v, min=0.0)
        sq = lambda v: (v * v).sum(-1)

        host = self._any_host

        def merit_and_theta(xi, lanes):
            l_e, l_i, c_e, c_i = self._true_constraints(xi, False, lanes if host else None)
            m = sq(c_e) + sq(pos(c_i)) + sq(l_e) + sq(pos(l_i))
            return m, flt.compute_constraint_val(l_e, l_i, c_e, c_i)

        def grad(xi, lanes):
            # 2 (J_e' c_e + J_i' max(c_i, 0) + A_eq' l_e + A_ineq' max(l_i, 0))
            (l_e, l_i, c_e, c_i), (J_e, J_i) = self._true_constraints(
                xi, True, lanes if host else None)
            tmv = lambda J, v: lane_matmul(v[..., None, :], J)[..., 0, :]
            return 2.0 * (tmv(J_e, c_e) + tmv(J_i, pos(c_i)) + tmv(A_eq, l_e)
                          + tmv(A_ineq, pos(l_i)))

        xi = self._restoration_start(state, r_guess)
        width = torch.where(torch.isfinite(ub - lb), ub - lb, torch.ones_like(lb))
        min_width = width.min()

        # budget (``algorithm.jl:370-384``): ``max_restoration_evals > 0``
        # caps the solve and suspends counting; else min(500 n, the
        # remaining budget of every nl-constraint group), two true passes an
        # iteration (gradient and candidate), so cap // 2 iterations, at
        # least 1 while any budget is left
        con_groups = [i for i, g in enumerate(mop.groups)
                      if any(mb.role in (NL_EQ, NL_INEQ) for mb in g.members)]
        B = x.shape[0]
        if ac.max_restoration_evals > 0:
            ev_cap = torch.full((B,), ac.max_restoration_evals, dtype=torch.int32,
                                device=self.device)
        else:
            ev_cap = torch.full((B,), 500 * mop.n_vars, dtype=torch.int32,
                                device=self.device)
            for i in con_groups:
                gmax = min(ac.max_evals, mop.groups[i].max_evals, 2 ** 31 - 1)
                ev_cap = torch.minimum(ev_cap, gmax - state.groups[i].n_evals)
            ev_cap = torch.clamp(ev_cap, min=0)
        cap = torch.where(ev_cap >= 1, torch.clamp(ev_cap // 2, min=1),
                          torch.zeros_like(ev_cap))
        stopval = 10 * torch.finfo(dtype).eps

        m_cur, t_best = merit_and_theta(xi, active)
        x_best = xi
        sc = torch.full_like(m_cur, 0.1)
        done = t_best <= stopval
        i_used = torch.zeros_like(cap)
        it = 0
        while True:
            go = ~done & (i_used < cap) & active
            if it % RESTORATION_SYNC_EVERY == 0 and not bool(go.any()):
                break
            g = grad(xi, go)
            gn = g.abs().amax(-1)
            step = torch.where(gn > 0, sc * min_width / gn, torch.zeros_like(gn))
            xi_n = project_into_box(xi - step[:, None] * g, lb, ub)
            m_n, t_n = merit_and_theta(xi_n, go)
            improved = m_n < m_cur
            better = t_n < t_best
            xi = lane_where(go & improved, xi_n, xi)
            m_cur = torch.where(go & improved, m_n, m_cur)
            sc = torch.where(go, torch.where(improved, torch.clamp(sc * 1.25, max=0.5),
                                             sc * 0.5), sc)
            x_best = lane_where(go & better, xi_n, x_best)
            t_best = torch.where(go, torch.minimum(t_best, t_n), t_best)
            done = torch.where(go, (t_best <= stopval) | (sc < 1e-10), done)
            i_used = i_used + go.to(i_used.dtype)
            it += 1
        self.restoration_iterations += it

        groups = state.groups
        if ac.max_restoration_evals <= 0:
            groups = tuple(st._replace(n_evals=st.n_evals + 2 * i_used)
                           if i in con_groups else st for i, st in enumerate(groups))
            state = state.replace(groups=groups)
        if self._log is not None:
            theta_r = t_best if not host else torch.where(
                active, t_best, torch.full_like(t_best, float("inf")))
            self._log.add(4, "|  Restoration: active={a} iters={i} theta_r={t:.3e}",
                          state.last_it_stat != ITER_TYPE.RESTORATION,
                          self._restoration_mark, a=active, i=i_used, t=theta_r)

        scal = state.scal
        x_r_s = scaling.transform(scal, x_best)
        fx_r, c_e_r, c_i_r, groups, idx_r = self._gated_evaluate_true(
            groups, x_r_s, scal, active if host else None)
        l_e_r, l_i_r = self._linear_values(x_r_s, scal)
        acceptable = flt.is_acceptable(state.filter, t_best, self._filter_objective(fx_r))
        accepted = self._finish_restoration(state.replace(
            x=x_best, x_s=x_r_s, fx=fx_r, l_e=l_e_r, l_i=l_i_r, c_e=c_e_r, c_i=c_i_r,
            groups=groups, x_indices=idx_r))
        failed = self._finish_early(state.replace(groups=groups), STOP_CODE.INFEASIBLE)
        return tree_where(acceptable, accepted, failed)

    def _finish_restoration(self, state: SolverState) -> SolverState:
        """Stamp and continue with it_stat RESTORATION (``algorithm.jl:702-709``)."""
        ninf = -float("inf")
        traj = self._stamp(state.traj, state.x, state.fx, state.delta, ninf, ninf,
                           ninf, int(ITER_TYPE.RESTORATION), state.x_indices,
                           state.groups)
        return state.replace(traj=traj, last_it_stat=int(ITER_TYPE.RESTORATION),
                             iter_counter=state.iter_counter + 1)

    def _finish_early(self, state: SolverState, code) -> SolverState:
        return state.replace(stop_code=int(code),
                             last_it_stat=int(ITER_TYPE.EARLY_EXIT),
                             iter_counter=state.iter_counter + 1)

    # ---------------------------------------------------------------- main phase
    def _main_phase(self, state: SolverState, inter: SolverState,
                    theta_k, theta_n, crit_halt, pre_stats, keep=None) -> SolverState:
        """Criticality + trial point + acceptance. ``state`` is the current
        iterate's bundle, ``inter`` the bundle at x+n (the same state on
        lanes that took no normal step, and on every criticality micro-trip:
        entry requires theta_k ~ 0). ``keep``: the lanes whose outcome of
        this phase is kept (None without host functions)."""
        in_crit = state.crit_mode > _MODE_NORMAL
        omega, d, groups_c = self._get_criticality(
            inter.groups, state.x_s, inter.x_s, inter.l_e, inter.l_i, inter.fx,
            state.delta, state.scal)
        # a halted criticality pass performs no work (``algorithm.jl:563-573``)
        groups_c = tree_where(crit_halt, inter.groups, groups_c)
        state = state.replace(groups=groups_c)
        inter = inter.replace(groups=groups_c)

        theta_k_zero = self._violation_zero(theta_k)
        # early CRITICAL exit (``algorithm.jl:728-732``), iteration starts only
        crit_exit = ((~in_crit) & self._violation_zero(theta_n)
                     & self._omega_tests(omega, state.delta))
        early = self._finish_early(inter.replace(delta=state.delta),
                                   STOP_CODE.CRITICAL)
        cont = self._crit_microstep(state, inter, theta_k, theta_k_zero,
                                    omega, d, crit_halt, pre_stats,
                                    self._keep(keep, crit_exit), ~crit_exit)
        return tree_where(crit_exit, early, cont)

    def _crit_microstep(self, state, inter, theta_k, theta_k_zero, omega, d,
                        halt, pre_stats, keep=None, reached=None):
        """``criticality_routine`` (``algorithm.jl:523-613``) as micro-steps
        of the outer loop, as in the JAX package: each pass (the
        make-fully-linear pre-step ``:536-551`` and every shrink pass
        ``:553-596``) is one outer trip with ``crit_mode > 0``; this applies
        the routine's control flow. Stabilized lanes fast-forward the
        remaining Delta bookkeeping and finish in the same trip. ``reached``:
        the lanes whose JAX run reaches this routine (the live log's)."""
        ac = self.ac
        mu = ac.mu
        beta = max(ac.beta, ac.mu)
        gamma_c = ac.gamma_crit

        mode = state.crit_mode
        normal = mode == _MODE_NORMAL
        first = mode == _MODE_CRIT_PRE
        looping = mode == _MODE_CRIT_LOOP
        n_loops = state.crit_nloops
        delta0 = state.delta
        groups = inter.groups
        fully_lin = self.container.fully_linear(groups)

        # NORMAL trips: entry decision (``algorithm.jl:536-551``)
        enter_crit = (normal & theta_k_zero & (omega <= ac.eps_crit)
                      & ((~fully_lin) | (delta0 > mu * omega)))
        enter_pre = enter_crit & (~fully_lin)
        enter_loop = enter_crit & fully_lin
        if self._log is not None:
            self._log.add(4, "|  Criticality test: mode={m} entered={e} omega={o:.3e} "
                          "fully_linear={f}", reached, m=mode, e=enter_crit, o=omega,
                          f=fully_lin)

        # CRIT_PRE trips: pre-step outcome (``:545-551``)
        do_loops_pre = first & fully_lin & (delta0 > mu * omega)

        # CRIT_LOOP trips: one shrink pass ran this trip, on the local copy
        passed = looping & (~halt)
        delta_eff = torch.where(passed, gamma_c * state.delta_loc, state.delta_loc)
        n_loops_eff = torch.where(passed, n_loops + 1, n_loops)
        tol_exit = passed & ((delta_eff <= ac.delta_tol_abs)
                             | self._omega_tests(omega, delta_eff)
                             | (~fully_lin))
        if self._log is not None:
            self._log.add(4, "|  (Criticality Test) pass {p}: active={a} "
                          "delta_loc={dl:.3e} omega={o:.3e} fully_linear={f}", reached,
                          p=n_loops_eff, a=passed | first, dl=delta_eff, o=omega,
                          f=fully_lin)

        # fixpoint certificate: a pass that left every group database
        # untouched proves the next pass is an identity (see the JAX
        # package), unless a group's phase 1 draws random numbers
        # (use_max_points re-keys every pass: JAX's ``_crit_ff``)
        stable = passed | do_loops_pre
        if self.container.draws:
            stable = torch.zeros_like(stable)
        for (cnt0, nev0), st in zip(pre_stats, groups):
            stable = stable & (cnt0 == st.db.count) & (nev0 == st.n_evals)

        would_cont = delta_eff > mu * omega
        cont_pre = do_loops_pre & (~stable)
        cont_loop = passed & (~tol_exit) & would_cont & (~stable)
        freeze = enter_pre | enter_loop | cont_pre | cont_loop

        # Delta-only fast-forward for stabilized lanes: the JAX package's
        # scalar while_loop, as masked trips. Every active trip either stops
        # the lane or raises its loop count, so max_critical_loops + 1 trips
        # cover every lane.
        ff_act = stable & (~tol_exit) & (do_loops_pre | passed)
        budget_x = self.container.budget_exhausted(groups)
        delta_l, nl = delta_eff, n_loops_eff
        exit_ff, done = torch.zeros_like(ff_act), ~ff_act
        for _ in range(ac.max_critical_loops + 1):
            active = (~done) & (delta_l > mu * omega)
            stop_now = (nl >= ac.max_critical_loops) | budget_x
            delta_n = torch.where(stop_now, delta_l, gamma_c * delta_l)
            t_exit = (~stop_now) & ((delta_n <= ac.delta_tol_abs)
                                    | self._omega_tests(omega, delta_n)
                                    | (~fully_lin))
            delta_l = torch.where(active, delta_n, delta_l)
            nl = torch.where(active & ~stop_now, nl + 1, nl)
            exit_ff = exit_ff | (active & (stop_now | t_exit))
            done = done | (active & (stop_now | t_exit))

        # finishing lanes: the Delta update applies only when shrink loops
        # were entered (``:605``)
        did_loops = looping | do_loops_pre
        exit_c = halt | tol_exit | exit_ff
        delta_new = torch.where(
            did_loops, torch.minimum(delta0, torch.maximum(beta * omega, delta_l)),
            delta0)
        exit_critical = did_loops & exit_c

        new_mode = torch.where(
            enter_pre, _MODE_CRIT_PRE,
            torch.where(enter_loop | cont_pre | cont_loop, _MODE_CRIT_LOOP,
                        _MODE_NORMAL))
        new_nloops = torch.where(enter_crit, 0, n_loops_eff)
        new_delta_loc = torch.where(enter_crit, delta0, delta_eff)

        # micro-step continues next trip: no stamp, no iteration advance
        frozen = inter.replace(crit_mode=new_mode, crit_nloops=new_nloops,
                               delta_loc=new_delta_loc)
        state_f = state.replace(delta=delta_new, crit_mode=0, crit_nloops=0)
        inter_f = inter.replace(delta=delta_new, crit_mode=0, crit_nloops=0)
        crit_exit = self._finish_early(inter_f, STOP_CODE.CRITICAL)
        trial = self._trial_point(state_f, inter_f, theta_k, omega, d,
                                  self._keep(keep, freeze | exit_critical),
                                  None if reached is None
                                  else reached & ~(freeze | exit_critical))
        return tree_where(freeze, frozen,
                          tree_where(exit_critical, crit_exit, trial))

    # ------------------------------------------------------------- trial point
    def _crossing_rows(self, state, inter, d):
        """The constraint rows of the initial stepsize's sigma search in
        crossing form ``(vals, dirs, rhs)`` (``descent.jl:276-292``): with
        constraints and ``delta_max > 1`` only, else ``(None, None,
        None)``. True linear rows along ``x_n + sigma d``, the nonlinear
        ones linearized at x and shifted by the normal step; equality rows
        twice with flipped sign."""
        if not (self.has_constraints and self.ac.delta_max > 1.0):
            return None, None, None
        x_s, x_n_s, scal = state.x_s, inter.x_s, state.scal
        groups, container = inter.groups, self.container
        A_eq_s, b_eq_s, A_ineq_s, b_ineq_s = self._lin_matrices(scal)
        n_step = x_n_s - x_s
        vals, dirs, rhs = [], [], []
        if A_ineq_s.shape[-2]:
            vals.append(_mv(A_ineq_s, x_n_s))
            dirs.append(_mv(A_ineq_s, d))
            rhs.append(b_ineq_s)
        if A_eq_s.shape[-2]:
            ve, de = _mv(A_eq_s, x_n_s), _mv(A_eq_s, d)
            vals += [ve, -ve]
            dirs += [de, -de]
            rhs += [b_eq_s, -b_eq_s]
        if self.mop.m_ci > 0:
            Dm_i = container.jac_nl_ineq(groups, x_s, scal)
            m_i = container.eval_nl_ineq_raw(groups, x_s, scal)
            vals.append(m_i + _mv(Dm_i, n_step))
            dirs.append(_mv(Dm_i, d))
            rhs.append(torch.zeros_like(m_i))
        if self.mop.m_ce > 0:
            Dm_e = container.jac_nl_eq(groups, x_s, scal)
            m_e = container.eval_nl_eq_raw(groups, x_s, scal)
            ve, de = m_e + _mv(Dm_e, n_step), _mv(Dm_e, d)
            vals += [ve, -ve]
            dirs += [de, -de]
            rhs += [torch.zeros_like(m_e)] * 2
        if not vals:
            return None, None, None
        return torch.cat(vals, -1), torch.cat(dirs, -1), torch.cat(rhs, -1)

    def _descent_step(self, state, inter, omega, d):
        """Steepest descent's trial point: the initial stepsize and Armijo
        backtracking (``compute_descent_step``). Returns ``(x_trial_s,
        omega, groups)``."""
        x_s, x_n_s, scal, container = state.x_s, inter.x_s, state.scal, self.container
        sigma = initial_stepsize(x_s, x_n_s, d, state.delta, scal.lb_scaled,
                                 scal.ub_scaled, *self._crossing_rows(state, inter, d))

        def eval_mx(groups, xq):
            return container.eval_objectives(groups, xq, scal)

        def eval_mx_batch(groups, X, k_used):
            if X is not None:
                return container.eval_objectives_batch(groups, X, scal), groups
            # the sequential Armijo loop evaluates only the objective
            # surrogates (``descent.jl:150-185``)
            return None, container.charge_evals(groups, k_used,
                                                objectives_only=True)

        x_trial_s, _, _, groups = backtrack(x_n_s, d, sigma, omega, eval_mx,
                                            inter.groups, self.desc_cfg,
                                            eval_mx_batch)
        # degenerate stepsize -> stay (``descent.jl:312-317``)
        usable = sigma > self.desc_cfg.min_stepsize
        x_trial_s = lane_where(usable, x_trial_s, x_n_s)
        omega = torch.where(usable, omega, torch.zeros_like(omega))
        return x_trial_s, omega, groups

    def _trial_point(self, state, inter, theta_k, omega, d, keep=None, reached=None):
        """Descent step, true evaluation, acceptance tests, radius update
        (``algorithm.jl:748-914``). Host groups evaluate the trial point at
        the lanes of ``keep`` only: the lanes that take this outcome,
        whether they accept the point or not. ``reached``: the lanes whose
        JAX run takes this outcome (the live log's)."""
        ac = self.ac
        x_s = state.x_s
        scal = state.scal
        container = self.container
        if isinstance(self.desc_cfg, SteepestDescentConfig):
            x_trial_s, omega, groups = self._descent_step(state, inter, omega, d)
        else:
            # Pascoletti-Serafini: the payload is the trial point
            # (``compute_descent_step`` fallback, ``descent.jl:36-41``)
            x_trial_s, groups = d, inter.groups
        x_trial = scaling.untransform(scal, x_trial_s)

        # true evaluation at the trial point (``algorithm.jl:760-764``)
        fx_t, c_e_t, c_i_t, groups, idx_t = container.evaluate_true(groups, x_trial_s,
                                                                    scal, keep)
        l_e_t, l_i_t = self._linear_values(x_trial_s, scal)
        # fresh surrogate values at x and x_trial (``:766-767``)
        mx, groups = container.eval_objectives(groups, x_s, scal)
        mx_t, groups = container.eval_objectives(groups, x_trial_s, scal)
        theta_t = flt.compute_constraint_val(l_e_t, l_i_t, c_e_t, c_i_t)
        f_t_filter = self._filter_objective(fx_t)
        steplength = (x_s - x_trial_s).abs().amax(-1)

        # acceptance tests (``:779-863``); the dummy filter accepts all
        if self.filter_mode == "dummy":
            acceptable_filter = torch.ones_like(theta_t, dtype=torch.bool)
        else:
            acceptable_filter = flt.is_acceptable_vs(
                state.filter, theta_t, f_t_filter, theta_k,
                self._filter_objective(state.fx), ac.filter_shift)
        nan = torch.full_like(omega, float("nan"))
        if ac.strict_acceptance_test:
            denom = mx - mx_t
            zero = denom == 0
            rho_raw = ((state.fx - fx_t)
                       / torch.where(zero, torch.ones_like(denom), denom)).amin(-1)
            rho_raw = torch.where(zero.any(-1), nan, rho_raw)
        else:
            denom = (mx.amax(-1) - mx_t.amax(-1))[:, None]
            rho_raw = (state.fx.amax(-1) - fx_t.amax(-1)) / denom[:, 0]
        good_decrease = acceptable_filter & (
            denom >= ac.filter_kappa_psi * theta_k[:, None] ** ac.filter_psi).all(-1)
        rho_raw = torch.where(acceptable_filter, rho_raw, nan)
        rho = torch.where(torch.isnan(rho_raw), torch.full_like(rho_raw, -float("inf")),
                          rho_raw)

        fully_lin = container.fully_linear(groups)
        IT, RU = ITER_TYPE, RADIUS_UPDATE
        w = torch.where
        success = rho >= ac.nu_success
        it_stat = w(acceptable_filter,
                    w(good_decrease,
                      w(success, IT.SUCCESSFULL,
                        w(fully_lin, w(rho >= ac.nu_accept, IT.ACCEPTABLE,
                                       IT.INACCEPTABLE), IT.MODELIMPROVING)),
                      IT.FILTER_ADD),
                    IT.FILTER_FAIL).to(torch.int32)
        accept = acceptable_filter & (~good_decrease | success
                                      | (fully_lin & (rho >= ac.nu_accept)))
        radius_update = w(
            acceptable_filter,
            w(good_decrease,
              w(success,
                w(state.delta < max(ac.beta, ac.mu) * omega, RU.GROW,
                  RU.LEAVE_UNCHANGED),
                w(fully_lin, w(rho >= ac.nu_accept, RU.SHRINK, RU.SHRINK_MUCH),
                  RU.LEAVE_UNCHANGED)),
              w(success, RU.GROW, RU.LEAVE_UNCHANGED)),
            RU.SHRINK_MUCH)
        delta_new = self._apply_radius_update(radius_update, state.delta, steplength)

        # filter entry (``:875-877``)
        filt = state.filter
        if self.filter_mode != "dummy":
            filt = tree_where(it_stat == IT.FILTER_ADD,
                              flt.add_entry(filt, theta_t, f_t_filter, ac.filter_shift),
                              filt)

        # next iterate (``:881-888``)
        take = lambda a, b: lane_where(accept, a, b)
        next_state = inter.replace(
            x=take(x_trial, inter.x), x_s=take(x_trial_s, inter.x_s),
            fx=take(fx_t, inter.fx), l_e=take(l_e_t, inter.l_e),
            l_i=take(l_i_t, inter.l_i), c_e=take(c_e_t, inter.c_e),
            c_i=take(c_i_t, inter.c_i), x_indices=take(idx_t, inter.x_indices),
            delta=delta_new, groups=groups, filter=filt)
        if self._log is not None:
            self._log.add(4, "|  Acceptance: it_stat={s} rho={r:.3e} omega={o:.3e} "
                          "steplength={l:.3e} accept={a} delta->{d:.3e}", reached,
                          s=it_stat, r=rho, o=omega, l=steplength, a=accept, d=delta_new)

        # stamp (``:899-903``), then the it_stat column of the stamped row
        traj = self._stamp(next_state.traj, next_state.x, next_state.fx,
                           delta_new, rho, omega, steplength, 0,
                           next_state.x_indices, next_state.groups)
        it_col = traj.n + traj.m + 4
        T = traj.data.shape[-2]
        row_hit = (torch.arange(T, device=self.device)
                   == torch.clamp(traj.count - 1, 0, T - 1)[:, None])
        data = traj.data.clone()
        data[..., it_col] = torch.where(row_hit, it_stat[:, None].to(data.dtype),
                                        data[..., it_col])
        next_state = next_state.replace(traj=dataclasses.replace(traj, data=data))

        # stopping tests (``:868-872`` + ``:905-914``)
        stepnorm_stop = (~accept) & (steplength <= ac.stepnorm_tol_abs)
        tol_stop = accept & self._tol_tests(state.x, x_trial, state.fx, fx_t)
        stop_code = torch.where(stepnorm_stop | tol_stop, STOP_CODE.TOLERANCE,
                                STOP_CODE.CONTINUE)
        return next_state.replace(stop_code=stop_code, last_it_stat=it_stat,
                                  iter_counter=state.iter_counter + 1)

    # ---------------------------------------------------------------- top level
    @_full_precision_matmuls()
    def solve_from_state(self, state: SolverState) -> tuple[SolverState, int]:
        """Run every lane to its stop code; returns the state and the number
        of outer trips."""
        trips = 0
        while True:
            running = state.stop_code == STOP_CODE.CONTINUE
            if not bool(running.any()):
                return state, trips
            state = tree_where(running, self.iterate(state), state)
            trips += 1

    @_full_precision_matmuls()
    def solve(self, x0, theta: tuple = ()) -> OptimizeResult:
        state, trips = self.solve_from_state(self.initialize(x0, theta=theta))
        return OptimizeResult(
            x=state.x, fx=state.fx, stop_code=state.stop_code,
            n_iterations=state.iter_counter - 1,
            n_evals=self._total_evals(state.groups), state=state, trips=trips)


def initialize_state(mop, x0, algo_config: Optional[AlgorithmConfig] = None,
                     dtype=torch.float64, device=None):
    """A solver and its initial state for the starts ``x0`` ((n,) or (B,
    n)), on CUDA unless ``device`` says otherwise."""
    ac = algo_config or AlgorithmConfig()
    if isinstance(mop, MOP):
        mop = compile_mop(mop, ac.combine_models)
    solver = Solver(mop, ac, dtype, resolve_device(device))
    return solver, solver.initialize(x0)


def untransform_databases(state: SolverState, lb, ub) -> SolverState:
    """The databases in unscaled coordinates (``untransform!(super_db,
    scal)``, ``algorithm.jl:952-954``), with the identity as the state's
    scaler, so that recycling through ``populated_db`` re-transforms the
    sites."""
    ones, zeros = torch.ones_like(state.scal.scale), torch.zeros_like(state.scal.offset)
    groups = tuple(st._replace(db=dbm.rescale(st.db, state.scal.scale, state.scal.offset,
                                              ones, zeros)) for st in state.groups)
    return state.replace(groups=groups, scal=scaling.VarScaler(
        scale=ones, offset=zeros, lb_scaled=lb.expand_as(ones).contiguous(),
        ub_scaled=ub.expand_as(ones).contiguous()))


def optimize(mop, x0, algo_config: Optional[AlgorithmConfig] = None,
             dtype=torch.float64, device=None, populated_db=None, verbosity: int = 0,
             **kwargs) -> OptimizeResult:
    """``optimize(mop, x0; ...)`` (``algorithm.jl:919-958``): one run, the
    B=1 case of the batched solver, with the lane axis removed from the
    result. Runs on CUDA unless ``device`` says otherwise. Extra keyword
    arguments are promoted into the config (``algorithm.jl:198-221``).
    ``populated_db`` recycles a previous run's databases
    (:meth:`Solver.initialize`); ``verbosity >= 1`` prints the final
    report, ``>= 2`` also a line per iteration replayed from the
    trajectory (``utils/logging.print_report``), ``>= 3`` the live lines
    while the run goes (the banner of each iteration; ``>= 4`` the normal
    step, restoration, criticality and acceptance; ``>= 5`` each group's
    model build; ``Solver(log_level=)``), as the JAX package prints them. With
    ``untransform_final_database`` the returned databases are in unscaled
    coordinates and the state's scaler is the identity."""
    if algo_config is None:
        algo_config = AlgorithmConfig(**kwargs)
    elif kwargs:
        algo_config = dataclasses.replace(algo_config, **kwargs)
    device = resolve_device(device)
    cmop = mop if isinstance(mop, CompiledMOP) else compile_mop(
        mop, algo_config.combine_models)
    solver = Solver(cmop, algo_config, dtype, device, x0_hint=x0, log_level=verbosity)
    state, trips = solver.solve_from_state(solver.initialize(x0, populated_db))
    if algo_config.untransform_final_database:
        state = untransform_databases(state, solver._lb, solver._ub)
    lane0 = lambda t: t[0]
    result = OptimizeResult(
        x=state.x[0], fx=state.fx[0], stop_code=state.stop_code[0],
        n_iterations=state.iter_counter[0] - 1,
        n_evals=solver._total_evals(state.groups)[0],
        state=tree_map(lane0, state), trips=trips)
    if verbosity >= 1:
        from morbit_tpu_torch.utils.logging import print_report
        print_report(result, verbosity=verbosity)
    return result
