"""Descent configurations, steepest descent and the normal step:
criticality LP, Armijo backtracking, initial stepsize, min-inf-norm normal
step.

Counterpart of ``morbit_tpu/core/descent.py`` (reference
``src/descent.jl``), batched over lanes. The Pascoletti-Serafini
subproblem itself is ``Solver._ps_criticality``; its configuration and
budgets are here. The multiobjective
steepest-descent direction is the min-max LP (``descent.jl:74-135``)::

    min_{beta, d}  beta   s.t.  Df d <= beta * ||rows||,  -1 <= d <= 1,
                               lb <= x + d <= ub,  A_eq d = b_eq,  A_ineq d <= b_ineq

solved with :func:`morbit_tpu_torch.ops.qp.solve_qp`; ``omega = -beta``.
The normal step (``descent.jl:691-758``) is the same kind of LP with an
epigraph variable; its infeasibility is signalled by NaN, as in the
reference (``:750-751``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from morbit_tpu_torch.ops.geometry import (_crossing_sigmas, intersect_bounds,
                                           local_bounds)
from morbit_tpu_torch.ops.batched_linalg import lane_matvec
from morbit_tpu_torch.ops.qp import solve_qp

_EPS64 = 2.0 ** -52


@dataclasses.dataclass(frozen=True)
class SteepestDescentConfig:
    """``SteepestDescentConfig`` (``descent.jl:53-72``) with reference defaults."""

    strict_backtracking: bool = True
    armijo_const_rhs: float = 1e-6
    armijo_const_shrink: float = 0.75
    min_stepsize: float = 10 * _EPS64
    max_loops: int = int(math.floor(math.log(10 * _EPS64) / math.log(0.75)))
    normalize: bool = True


@dataclasses.dataclass(frozen=True)
class PascolettiSerafiniConfig:
    """``PascolettiSerafiniConfig`` (``descent.jl:323-349``).

    NLopt's :GN_ISRES global stage is a Halton sweep over the local box,
    and the optional local polish (``ps_polish``, the ``ps_polish_algo``
    analogue, off by default as in the reference) projected gradient steps
    on the scalarization. ``n_samples`` / ``polish_iters`` override the
    resolved grid and polish budgets (negative: the reference mapping)."""

    reference_point: tuple = ()
    reference_direction: tuple = ()
    trust_region_factor: float = 1.0
    max_ps_problem_evals: int = -1
    max_ps_polish_evals: int = -1
    max_ideal_point_problem_evals: int = -1
    ps_polish: bool = False
    n_samples: int = -1
    polish_iters: int = -1


def ps_subsolver_budgets(cfg: PascolettiSerafiniConfig, n_vars: int):
    """The PS subsolvers' sample and polish budgets, ``(ps_grid, ps_polish,
    ideal_grid, ideal_polish)``: ``_ps_max_evals`` (``descent.jl:414-432``)
    and the ideal-point budget (``:527``) with the reference defaults. The
    total is ``500 (n_vars + 1)`` or ``max_ps_problem_evals``, all of it on
    the sweep unless polish is opted into (``ps_polish``, or setting
    ``max_ps_polish_evals`` or ``polish_iters``); then 3/4 sweep and 1/4
    polish, unless ``max_ps_polish_evals`` caps the polish and leaves the
    sweep the whole total. Each ideal-point solve has its own sweep of
    ``500 (n_vars + 1)`` or ``max_ideal_point_problem_evals`` (``:527-536``)."""
    ref_total = 500 * (n_vars + 1)
    polish_on = (cfg.ps_polish or cfg.max_ps_polish_evals >= 0
                 or cfg.polish_iters >= 0)
    explicit_polish = (cfg.max_ps_polish_evals if cfg.max_ps_polish_evals >= 0
                       else cfg.polish_iters)
    total = (cfg.max_ps_problem_evals if cfg.max_ps_problem_evals >= 0
             else (cfg.n_samples if cfg.n_samples >= 0 else ref_total))
    if not polish_on:
        ps_grid, ps_polish = total, 0
    elif explicit_polish >= 0:
        ps_grid, ps_polish = total, explicit_polish
    else:
        ps_grid = max(total * 3 // 4, 1)
        ps_polish = total - ps_grid
    if cfg.max_ideal_point_problem_evals >= 0:
        # the reference's ideal-point solves are one global stage
        ideal_grid, ideal_polish = cfg.max_ideal_point_problem_evals, 0
    else:
        ideal_grid = cfg.n_samples if cfg.n_samples >= 0 else ref_total
        ideal_polish = cfg.polish_iters if cfg.polish_iters >= 0 else 0
    return max(ps_grid, 1), ps_polish, max(ideal_grid, 1), ideal_polish


def resolve_descent_config(spec):
    """A descent config from a config object, a name, or a dict of a
    config's fields (``dataclasses.asdict`` of the JAX package's)."""
    if isinstance(spec, (SteepestDescentConfig, PascolettiSerafiniConfig)):
        return spec
    if isinstance(spec, dict):
        kind = PascolettiSerafiniConfig if "reference_point" in spec else SteepestDescentConfig
        return kind(**spec)
    if spec in ("steepest_descent", "steepest", "sd"):
        return SteepestDescentConfig()
    if spec in ("ps", "pascoletti_serafini"):
        return PascolettiSerafiniConfig()
    raise ValueError(f"unknown descent method {spec!r}")


class LinearizedConstraints(NamedTuple):
    """Linear(ized) constraint rows of the subproblems, in scaled space, per
    lane: ``A_eq d - b_eq == 0`` and ``A_ineq d - b_ineq <= 0`` for a step
    ``d`` from the expansion point; the true linear constraints and the
    surrogate linearizations of the nonlinear ones (``descent.jl:199-236``).
    ``A_*`` are (B, p, n), ``b_*`` (B, p); zero rows when absent."""

    A_eq: torch.Tensor
    b_eq: torch.Tensor
    A_ineq: torch.Tensor
    b_ineq: torch.Tensor


def _rows(M, extra_cols: int):
    """Constraint rows ``M`` (B, k, n) with ``extra_cols`` zero columns."""
    return torch.cat([M, M.new_zeros(M.shape[:-1] + (extra_cols,))], dim=-1)


def descent_lp(x_n, Dm, lb, ub, normalize: bool = True, lin=None):
    """The min-max LP of every lane in OSQP form ``(P, q, A, l, u)``:
    variables ``(d, beta)``, ``nv = n + 1`` and ``m_obj + 2n + p + q`` rows
    (descent rows, ``|d| <= 1``, the box, then ``lin``'s rows)."""
    B, n = x_n.shape
    m = Dm.shape[-2]
    dtype, dev = x_n.dtype, x_n.device
    if normalize:
        c = torch.linalg.vector_norm(Dm, dim=-1)
        c = torch.where(c > 0, c, torch.ones_like(c))
    else:
        c = torch.ones((B, m), dtype=dtype, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev).expand(B, n, n)
    zcol = torch.zeros((B, n, 1), dtype=dtype, device=dev)
    blocks = [torch.cat([Dm, -c[..., None]], dim=-1),      # descent rows
              torch.cat([eye, zcol], dim=-1),              # |d| <= 1
              torch.cat([eye, zcol], dim=-1)]              # box
    inf = torch.full((B, m), float("inf"), dtype=dtype, device=dev)
    ones = torch.ones((B, n), dtype=dtype, device=dev)
    l = [-inf, -ones, lb - x_n]
    u = [torch.zeros_like(inf), ones, ub - x_n]
    if lin is not None:
        blocks += [_rows(lin.A_eq, 1), _rows(lin.A_ineq, 1)]
        l += [lin.b_eq, torch.full_like(lin.b_ineq, -float("inf"))]
        u += [lin.b_eq, lin.b_ineq]
    qv = torch.zeros((B, n + 1), dtype=dtype, device=dev)
    qv[:, n] = 1.0
    P = torch.zeros((B, n + 1, n + 1), dtype=dtype, device=dev)
    return P, qv, torch.cat(blocks, dim=-2), torch.cat(l, dim=-1), torch.cat(u, dim=-1)


def steepest_descent_direction(x_n, Dm, lb, ub, lin=None, normalize: bool = True,
                               qp_iters: int = 400, qp_exit_eps: float = 0.0):
    """Solve the min-max LP per lane; returns (d (B, n), omega (B,)).
    ``descent.jl:91-135``. On solver failure the reference returns a zero
    step with ``omega = -inf`` (``:130-134``)."""
    n = x_n.shape[-1]
    sol = solve_qp(*descent_lp(x_n, Dm, lb, ub, normalize, lin), iters=qp_iters,
                   exit_eps=qp_exit_eps)
    d = sol.z[:, :n]
    omega = -sol.z[:, n]
    ok = sol.status_ok & torch.isfinite(d).all(-1)
    d = torch.where(ok[:, None], d, torch.zeros_like(d))
    omega = torch.where(ok, omega, torch.full_like(omega, -float("inf")))
    return d, omega


def backtrack(x_n, d, sigma0, omega, eval_mx, states, cfg: SteepestDescentConfig,
              eval_mx_batch):
    """Armijo backtracking on the surrogates (``descent.jl:150-185``).

    The candidate stepsizes are the fixed ladder ``sigma0 * alpha^k``; all
    ``max_loops + 1`` trial points are evaluated in one batched call and
    the accepted index is the first k with (armijo_k or sigma_k <=
    min_step) — the sequential loop's choice. ``eval_mx(states, x) -> (mx,
    states)`` counts one exact-model eval; ``eval_mx_batch(states, X, None)
    -> (MX, states)`` evaluates the ladder uncounted and
    ``eval_mx_batch(states, None, k_used)`` charges the ``k* + 1`` evals the
    sequential loop would have made. Returns (x_plus, mx_plus, step, states)."""
    dtype, dev = x_n.dtype, x_n.device
    K = cfg.max_loops + 1

    mx, states = eval_mx(states, x_n)
    alpha = torch.tensor(cfg.armijo_const_shrink, dtype=dtype, device=dev)
    sigmas = sigma0[:, None] * alpha ** torch.arange(K, dtype=dtype, device=dev)
    X = x_n[:, None, :] + sigmas[..., None] * d[:, None, :]     # (B, K, n)

    MX, states = eval_mx_batch(states, X, None)
    rhs = sigmas * cfg.armijo_const_rhs * omega[:, None]
    if cfg.strict_backtracking:
        ok = (mx[:, None, :] - MX >= rhs[..., None]).all(-1)
    else:
        ok = (mx.amax(-1)[:, None] - MX.amax(-1)) >= rhs
    ok = ok | (sigmas <= cfg.min_stepsize)
    first = torch.argmax(ok.to(torch.int32), dim=-1)
    k_star = torch.where(ok.any(-1), first, torch.full_like(first, K - 1))
    _, states = eval_mx_batch(states, None, k_star + 1)

    take = k_star[:, None]
    sigma = torch.gather(sigmas, 1, take)[:, 0]
    x_t = torch.gather(X, 1, take[..., None].expand(-1, 1, X.shape[-1]))[:, 0]
    mx_t = torch.gather(MX, 1, take[..., None].expand(-1, 1, MX.shape[-1]))[:, 0]
    return x_t, mx_t, sigma[:, None] * d, states


def initial_stepsize(x, x_n, d, delta, lb, ub, con_vals=None, con_dirs=None,
                     con_rhs=None):
    """Initial backtracking stepsize sigma per lane (``descent.jl:253-310``).

    For ``Delta > 1`` with ``||d|| ~ 1`` the reference intersects the ray
    ``x_n + sigma*d`` with the local box and every (true linear and
    surrogate-linearized) constraint row (``descent.jl:276-292``); callers
    pass those rows in crossing form ``con_vals + sigma * con_dirs <=
    con_rhs`` (B, k), equality rows twice with flipped sign, or ``None``."""
    lb_eff, ub_eff = local_bounds(x, delta, lb, ub)
    took_normal = ~torch.isclose(x, x_n).all(-1)
    sigma_box = intersect_bounds(x_n, d, lb_eff, ub_eff, ret_mode="pos")
    delta_eff = torch.where(took_normal, sigma_box, delta)
    norm_d = d.abs().amax(-1)
    norm_d_safe = torch.where(norm_d > 0, norm_d, torch.ones_like(norm_d))
    sigma_small = torch.clamp(delta_eff / norm_d_safe, max=1.0)
    # Delta > 1 branch: step until the local box (or a linearized
    # constraint) is hit, when ||d||_inf ~ 1
    if con_vals is not None and con_vals.shape[-1] > 0:
        s = _crossing_sigmas(con_vals, con_rhs, con_dirs, sense_lb=False)
        # rows never crossed along the ray impose no cap (+inf, as the
        # reference's positive minimum over box and rows together)
        sigma_con = torch.where(s >= 0, s, torch.full_like(s, float("inf"))).amin(-1)
        sigma_box = torch.minimum(sigma_box, sigma_con)
    one = torch.ones_like(norm_d)
    sigma_big = torch.where(torch.isclose(norm_d, one), sigma_box, one)
    return torch.where(delta_eff <= 1.0, sigma_small, sigma_big)


def normal_lp(x, lb, ub, lin: LinearizedConstraints, kappa_delta: float,
              delta_max: float, variable_radius):
    """The normal-step LP of every lane in OSQP form ``(P, q, A, l, u)``
    (``compute_normal_step``, ``descent.jl:691-758``): variables ``(n, a,
    del)``, ``nv = n + 2``; rows ``n_i - a <= 0``, ``-n_i - a <= 0``, ``a >=
    0``, the box, ``lin``'s rows, ``a - kappa_delta del <= 0`` (binding only
    with ``variable_radius``, (B,) bool) and ``del <= delta_max``. The
    objective is ``a``, or ``del`` with ``variable_radius``."""
    B, n = x.shape
    dtype, dev = x.dtype, x.device
    eye = torch.eye(n, dtype=dtype, device=dev).expand(B, n, n)
    ones = torch.ones((B, n, 1), dtype=dtype, device=dev)
    zn = torch.zeros((B, n, 1), dtype=dtype, device=dev)
    # the rows of (a, del): a >= 0, a - kappa_delta del <= 0, del <= delta_max
    tail = torch.zeros((B, 3, n + 2), dtype=dtype, device=dev)
    tail[:, 0, n] = 1.0
    tail[:, 1, n] = 1.0
    tail[:, 1, n + 1] = -kappa_delta
    tail[:, 2, n + 1] = 1.0
    A = torch.cat([
        torch.cat([eye, -ones, zn], dim=-1),
        torch.cat([-eye, -ones, zn], dim=-1),
        tail[:, :1],
        torch.cat([eye, zn, zn], dim=-1),
        _rows(lin.A_eq, 2), _rows(lin.A_ineq, 2),
        tail[:, 1:]], dim=-2)
    full = lambda k, v: torch.full((B, k), v, dtype=dtype, device=dev)
    inf = float("inf")
    zero_or_inf = torch.where(variable_radius, 0.0, inf).to(dtype)[:, None]
    l = torch.cat([full(2 * n, -inf), full(1, 0.0), lb - x, lin.b_eq,
                   torch.full_like(lin.b_ineq, -inf), full(1, -inf), full(1, 0.0)], dim=-1)
    u = torch.cat([full(2 * n, 0.0), full(1, inf), ub - x, lin.b_eq, lin.b_ineq,
                   zero_or_inf, full(1, delta_max)], dim=-1)
    qv = torch.zeros((B, n + 2), dtype=dtype, device=dev)
    qv[:, n] = torch.where(variable_radius, 0.0, 1.0).to(dtype)
    qv[:, n + 1] = torch.where(variable_radius, 1.0, 0.0).to(dtype)
    P = torch.zeros((B, n + 2, n + 2), dtype=dtype, device=dev)
    return P, qv, A, l, u


def normal_step(x, lb, ub, lin: LinearizedConstraints, kappa_delta: float,
                delta_max: float, delta, variable_radius, qp_iters: int = 400,
                qp_exit_eps: float = 0.0):
    """Min-inf-norm step onto the linearized feasible set per lane
    (``compute_normal_step``, ``descent.jl:691-758``). ``lin`` carries rows
    with their right-hand sides at ``x``. Returns (n (B, n), Delta (B,),
    feasible (B,)); an infeasible lane's step is NaN."""
    n = x.shape[-1]
    dtype = x.dtype
    sol = solve_qp(*normal_lp(x, lb, ub, lin, kappa_delta, delta_max,
                              variable_radius), iters=qp_iters, exit_eps=qp_exit_eps)
    # clip tiny box violations (``descent.jl:756``)
    n_step = torch.minimum(torch.maximum(x + sol.z[:, :n], lb), ub) - x
    # post-clip feasibility test against the (row-equilibrated) constraint
    # rows, the JAX package's stand-in for OSQP's primal-infeasibility
    # certificate (``descent.jl:750``): the clip concentrates an infeasible
    # LP's violation in those rows
    # 10 sqrt(eps) rounded in the dtype, as the JAX package computes it
    eps = 1e-6 if torch.finfo(dtype).bits <= 32 else 1e-8
    feas_tol = float(10.0 * torch.sqrt(torch.tensor(eps, dtype=dtype)))
    viol = torch.zeros_like(sol.z[:, 0])
    mv = lane_matvec
    if lin.A_eq.shape[-2]:
        viol = torch.maximum(viol, (mv(lin.A_eq, n_step) - lin.b_eq).abs().amax(-1))
    if lin.A_ineq.shape[-2]:
        viol = torch.maximum(viol, (mv(lin.A_ineq, n_step) - lin.b_ineq).amax(-1))
    feasible = sol.status_ok & (viol <= feas_tol)
    n_step = torch.where(feasible[:, None], n_step, torch.full_like(n_step, float("nan")))
    delta_out = torch.where(variable_radius, sol.z[:, n + 1], delta)
    return n_step, delta_out, feasible
