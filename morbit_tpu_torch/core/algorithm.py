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
the unconstrained (box-constrained) path with exact and RBF models and
steepest descent.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from morbit_tpu_torch.core import filter as flt
from morbit_tpu_torch.core import scaling
from morbit_tpu_torch.core.config import AlgorithmConfig
from morbit_tpu_torch.core.descent import (backtrack, initial_stepsize,
                                           resolve_descent_config,
                                           steepest_descent_direction)
from morbit_tpu_torch.core.enums import ITER_TYPE, RADIUS_UPDATE, STOP_CODE
from morbit_tpu_torch.core.mop import CompiledMOP, compile_mop
from morbit_tpu_torch.models.container import SurrogateContainer
from morbit_tpu_torch.ops.geometry import project_into_box
from morbit_tpu_torch.utils.tree import lane_where, tree_map, tree_where

#: criticality micro-step modes (``SolverState.ints[:, 3]``): the
#: criticality routine (``algorithm.jl:523-613``) runs as micro-steps of the
#: outer loop, one rebuild pass per trip, as in the JAX package
_MODE_NORMAL, _MODE_CRIT_PRE, _MODE_CRIT_LOOP = 0, 1, 2


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
    dlt: torch.Tensor    # (B, 2)
    ints: torch.Tensor   # (B, 5 + G) int32
    groups: tuple        # tuple[GroupState]
    filter: flt.FilterState
    traj: TrajectoryState
    scal: scaling.VarScaler  # (B, n) fields

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
    batched state."""

    def __init__(self, mop: CompiledMOP, ac: Optional[AlgorithmConfig] = None,
                 dtype=torch.float64, device="cuda"):
        self.mop = mop
        self.ac = ac = ac or AlgorithmConfig()
        self.dtype = dtype
        self.device = torch.device(device)
        _unported = {
            "var_scaler_update": ac.var_scaler_update != "none",
            "use_db": not ac.use_db,
            "qp_exit_eps": ac.qp_exit_eps != 0,
            "untransform_final_database": ac.untransform_final_database,
        }
        for name, bad in _unported.items():
            if bad:
                raise NotImplementedError(
                    f"AlgorithmConfig.{name}={getattr(ac, name)!r} is not "
                    "ported to morbit_tpu_torch yet")
        self.scal = scaling.get_var_scaler(self._tensor(mop.lb),
                                           self._tensor(mop.ub), ac.var_scaler)
        # the largest per-rebuild working set of any group (n+1 without an
        # RBF group); RBF groups insert no stencil, so no per-iteration
        # site bound (JAX algorithm.py:308-330)
        max_model_pts = max([g.cfg.resolved_max_points(mop.n_vars)
                             for g in mop.groups
                             if hasattr(g.cfg, "resolved_max_points")],
                            default=mop.n_vars + 1)
        self.db_capacity = ac.resolved_db_capacity(mop.n_vars, max_model_pts, 0)
        self.container = SurrogateContainer(mop, dtype, ac, self.db_capacity,
                                            self.device)
        self.desc_cfg = resolve_descent_config(ac.descent_method)
        self.T = ac.resolved_trajectory_capacity()
        #: width of the per-iteration training-set stamp (save_model_meta)
        self.MW = self.container.train_stamp_len if ac.save_model_meta else 0

    # ------------------------------------------------------------------ helpers
    def _tensor(self, v, dtype=None):
        return torch.as_tensor(v, dtype=dtype or self.dtype, device=self.device)

    def _violation_zero(self, theta):
        """``constraint_violation_is_zero`` (``utilities.jl:335-342``)."""
        return theta.abs() <= 10 * torch.finfo(self.dtype).eps

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

    def _get_criticality(self, groups, x_s, x_n_s, delta, scal):
        """``get_criticality`` (``descent.jl:19-25``), steepest descent:
        returns ``(omega, d, groups)``; the LP reads model Jacobians only
        and charges nothing."""
        Dm = self.container.jac_objectives(groups, x_n_s, scal)
        d, omega = steepest_descent_direction(
            x_n_s, Dm, scal.lb_scaled, scal.ub_scaled,
            normalize=self.desc_cfg.normalize, qp_iters=self.ac.qp_iters)
        return omega, d, groups

    # ------------------------------------------------------------- initialization
    @_full_precision_matmuls()
    def initialize(self, x0) -> SolverState:
        """``initialize_data`` (``algorithm.jl:223-323``) for a (B, n) batch
        of starting points (a single (n,) start is the batch of one)."""
        mop, dtype, dev = self.mop, self.dtype, self.device
        x0 = self._tensor(x0)
        if x0.dim() == 1:
            x0 = x0[None]
        B, n = x0.shape
        x = project_into_box(x0, self._tensor(mop.lb), self._tensor(mop.ub))
        scal = scaling.VarScaler(*(f.expand(B, n).contiguous() for f in self.scal))
        x_s = scaling.transform(scal, x)

        groups = self.container.init_group_states(B)
        fx, groups, x_indices = self.container.ensure_evaluated(groups, x_s, scal)
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
        return SolverState(
            x=x, x_s=x_s, fx=fx, dlt=torch.stack([delta0, delta0], dim=-1),
            ints=ints, groups=groups,
            filter=flt.init_filter(B, 0, 1, dtype, dev), traj=traj, scal=scal)

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
        return tree_where(go, self._iterate_inner(state),
                          state.replace(stop_code=stop))

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

    def _iterate_inner(self, state: SolverState) -> SolverState:
        ac = self.ac
        in_crit = state.crit_mode > _MODE_NORMAL
        looping = state.crit_mode == _MODE_CRIT_LOOP
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
        upd = self.container.update_or_improve(
            state.groups, state.x_s, state.x_indices, state.delta,
            improve_flag, scal=state.scal, efl_flag=in_crit)
        state = state.replace(groups=tree_where(do_update, upd, state.groups))

        theta_k = torch.zeros_like(state.delta)  # no constraints
        return self._main_phase(state, state, theta_k, theta_k, crit_halt,
                                pre_stats)

    def _finish_early(self, state: SolverState, code) -> SolverState:
        return state.replace(stop_code=int(code),
                             last_it_stat=int(ITER_TYPE.EARLY_EXIT),
                             iter_counter=state.iter_counter + 1)

    # ---------------------------------------------------------------- main phase
    def _main_phase(self, state: SolverState, inter: SolverState,
                    theta_k, theta_n, crit_halt, pre_stats) -> SolverState:
        """Criticality + trial point + acceptance. ``state`` is the current
        iterate's bundle, ``inter`` the bundle at x+n (the same object
        without a normal step, i.e. always in this slice)."""
        in_crit = state.crit_mode > _MODE_NORMAL
        omega, d, groups_c = self._get_criticality(
            inter.groups, state.x_s, inter.x_s, state.delta, state.scal)
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
                                    omega, d, crit_halt, pre_stats)
        return tree_where(crit_exit, early, cont)

    def _crit_microstep(self, state, inter, theta_k, theta_k_zero, omega, d,
                        halt, pre_stats):
        """``criticality_routine`` (``algorithm.jl:523-613``) as micro-steps
        of the outer loop, as in the JAX package: each pass (the
        make-fully-linear pre-step ``:536-551`` and every shrink pass
        ``:553-596``) is one outer trip with ``crit_mode > 0``; this applies
        the routine's control flow. Stabilized lanes fast-forward the
        remaining Delta bookkeeping and finish in the same trip."""
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

        # CRIT_PRE trips: pre-step outcome (``:545-551``)
        do_loops_pre = first & fully_lin & (delta0 > mu * omega)

        # CRIT_LOOP trips: one shrink pass ran this trip, on the local copy
        passed = looping & (~halt)
        delta_eff = torch.where(passed, gamma_c * state.delta_loc, state.delta_loc)
        n_loops_eff = torch.where(passed, n_loops + 1, n_loops)
        tol_exit = passed & ((delta_eff <= ac.delta_tol_abs)
                             | self._omega_tests(omega, delta_eff)
                             | (~fully_lin))

        # fixpoint certificate: a pass that left every group database
        # untouched proves the next pass is an identity (see the JAX
        # package); no ported model's phase 1 draws random numbers
        stable = passed | do_loops_pre
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
        trial = self._trial_point(state_f, inter_f, theta_k, omega, d)
        return tree_where(freeze, frozen,
                          tree_where(exit_critical, crit_exit, trial))

    # ------------------------------------------------------------- trial point
    def _trial_point(self, state, inter, theta_k, omega, d):
        """Descent step, true evaluation, acceptance tests, radius update
        (``algorithm.jl:748-914``)."""
        ac = self.ac
        x_s = state.x_s
        x_n_s = inter.x_s
        scal = state.scal
        container = self.container

        sigma = initial_stepsize(x_s, x_n_s, d, state.delta, scal.lb_scaled,
                                 scal.ub_scaled)

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
        x_trial = scaling.untransform(scal, x_trial_s)

        # true evaluation at the trial point (``algorithm.jl:760-764``)
        fx_t, groups, idx_t = container.evaluate_true(groups, x_trial_s, scal)
        # fresh surrogate values at x and x_trial (``:766-767``)
        mx, groups = container.eval_objectives(groups, x_s, scal)
        mx_t, groups = container.eval_objectives(groups, x_trial_s, scal)
        steplength = (x_s - x_trial_s).abs().amax(-1)

        # acceptance tests (``:779-863``); the dummy filter accepts all
        acceptable_filter = torch.ones_like(usable)
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

        # next iterate (``:881-888``)
        next_state = inter.replace(
            x=lane_where(accept, x_trial, inter.x),
            x_s=lane_where(accept, x_trial_s, inter.x_s),
            fx=lane_where(accept, fx_t, inter.fx),
            x_indices=lane_where(accept, idx_t, inter.x_indices),
            delta=delta_new, groups=groups)

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
    def solve(self, x0) -> OptimizeResult:
        state, trips = self.solve_from_state(self.initialize(x0))
        return OptimizeResult(
            x=state.x, fx=state.fx, stop_code=state.stop_code,
            n_iterations=state.iter_counter - 1,
            n_evals=self._total_evals(state.groups), state=state, trips=trips)


def optimize(mop, x0, algo_config: Optional[AlgorithmConfig] = None,
             dtype=torch.float64, device=None, **kwargs) -> OptimizeResult:
    """``optimize(mop, x0; ...)`` (``algorithm.jl:919-958``): one run, the
    B=1 case of the batched solver, with the lane axis removed from the
    result. Runs on CUDA unless ``device`` says otherwise. Extra keyword
    arguments are promoted into the config (``algorithm.jl:198-221``)."""
    if algo_config is None:
        algo_config = AlgorithmConfig(**kwargs)
    elif kwargs:
        algo_config = dataclasses.replace(algo_config, **kwargs)
    device = resolve_device(device)
    cmop = mop if isinstance(mop, CompiledMOP) else compile_mop(
        mop, algo_config.combine_models)
    res = Solver(cmop, algo_config, dtype, device).solve(x0)
    lane0 = lambda t: t[0]
    return OptimizeResult(
        x=res.x[0], fx=res.fx[0], stop_code=res.stop_code[0],
        n_iterations=res.n_iterations[0], n_evals=res.n_evals[0],
        state=tree_map(lane0, res.state), trips=res.trips)

