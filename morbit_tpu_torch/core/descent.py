"""Steepest descent: criticality LP, Armijo backtracking, initial stepsize.

Counterpart of the steepest-descent part of ``morbit_tpu/core/descent.py``
(reference ``src/descent.jl``), batched over lanes. The multiobjective
steepest-descent direction is the min-max LP (``descent.jl:74-135``)::

    min_{beta, d}  beta   s.t.  Df d <= beta * ||rows||,  -1 <= d <= 1,
                               lb <= x + d <= ub

solved with :func:`morbit_tpu_torch.ops.qp.solve_qp`; ``omega = -beta``.
Constraint rows arrive with the constraints slice.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from morbit_tpu_torch.ops.geometry import intersect_bounds, local_bounds
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


def resolve_descent_config(spec):
    if isinstance(spec, SteepestDescentConfig):
        return spec
    if isinstance(spec, dict):
        return SteepestDescentConfig(**spec)
    if spec in ("steepest_descent", "steepest", "sd"):
        return SteepestDescentConfig()
    if spec in ("ps", "pascoletti_serafini"):
        raise NotImplementedError(
            "Pascoletti-Serafini descent is not ported to morbit_tpu_torch "
            "yet: it arrives with the Pascoletti-Serafini slice")
    raise ValueError(f"unknown descent method {spec!r}")


def descent_lp(x_n, Dm, lb, ub, normalize: bool = True):
    """The min-max LP of every lane in OSQP form ``(P, q, A, l, u)``:
    variables ``(d, beta)``, ``nv = n + 1`` and ``m_obj + 2n`` rows."""
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
    A = torch.cat([
        torch.cat([Dm, -c[..., None]], dim=-1),      # descent rows
        torch.cat([eye, zcol], dim=-1),              # |d| <= 1
        torch.cat([eye, zcol], dim=-1),              # box
    ], dim=-2)
    inf = torch.full((B, m), float("inf"), dtype=dtype, device=dev)
    ones = torch.ones((B, n), dtype=dtype, device=dev)
    l = torch.cat([-inf, -ones, lb - x_n], dim=-1)
    u = torch.cat([torch.zeros_like(inf), ones, ub - x_n], dim=-1)
    qv = torch.zeros((B, n + 1), dtype=dtype, device=dev)
    qv[:, n] = 1.0
    P = torch.zeros((B, n + 1, n + 1), dtype=dtype, device=dev)
    return P, qv, A, l, u


def steepest_descent_direction(x_n, Dm, lb, ub, normalize: bool = True,
                               qp_iters: int = 400):
    """Solve the min-max LP per lane; returns (d (B, n), omega (B,)).
    ``descent.jl:91-135``. On solver failure the reference returns a zero
    step with ``omega = -inf`` (``:130-134``)."""
    n = x_n.shape[-1]
    sol = solve_qp(*descent_lp(x_n, Dm, lb, ub, normalize), iters=qp_iters)
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


def initial_stepsize(x, x_n, d, delta, lb, ub):
    """Initial backtracking stepsize sigma per lane (``descent.jl:253-310``),
    box-constrained form."""
    lb_eff, ub_eff = local_bounds(x, delta, lb, ub)
    took_normal = ~torch.isclose(x, x_n).all(-1)
    sigma_box = intersect_bounds(x_n, d, lb_eff, ub_eff, ret_mode="pos")
    delta_eff = torch.where(took_normal, sigma_box, delta)
    norm_d = d.abs().amax(-1)
    norm_d_safe = torch.where(norm_d > 0, norm_d, torch.ones_like(norm_d))
    sigma_small = torch.clamp(delta_eff / norm_d_safe, max=1.0)
    # Delta > 1 branch: step until the local box is hit, when ||d||_inf ~ 1
    one = torch.ones_like(norm_d)
    sigma_big = torch.where(torch.isclose(norm_d, one), sigma_box, one)
    return torch.where(delta_eff <= 1.0, sigma_small, sigma_big)
