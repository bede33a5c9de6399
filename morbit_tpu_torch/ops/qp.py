"""Batched dense QP/LP solver (fixed-iteration ADMM + active-set polish).

Counterpart of ``morbit_tpu/ops/qp.py``, batched over a leading lane axis:
``P`` (B, nv, nv), ``q`` (B, nv), ``A`` (B, m, nv), ``l``/``u`` (B, m).
Problem form (OSQP form)::

    min 1/2 z' P z + q' z   s.t.   l <= A z <= u

Equality rows have ``l == u``; free rows have infinite bounds. The ADMM
stage loop runs in :func:`morbit_tpu_torch.ops.qp_lane.admm_stages` (the
CUDA kernel on the card, its plain twin on the CPU); row equilibration, the
per-row penalty and the polish stay here in plain torch, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from morbit_tpu_torch.ops import lane_linalg, qp_lane
from morbit_tpu_torch.ops.batched_linalg import GJ_MAX_K, gj_inverse, lane_matvec


class QPSolution(NamedTuple):
    z: torch.Tensor          # (B, nv) primal solution
    y: torch.Tensor          # (B, m) dual solution
    obj: torch.Tensor        # (B,) objective value at z
    prim_res: torch.Tensor   # (B,) ||clip violation||_inf
    dual_res: torch.Tensor   # (B,) ||P z + q + A' y||_inf
    status_ok: torch.Tensor  # (B,) bool: residuals below tolerance


def _is_f32(dtype) -> bool:
    return torch.finfo(dtype).bits <= 32


_mv = lane_matvec


def _rho_vec(l, u, rho: float):
    """Per-row penalty: OSQP uses ``rho*1e3`` on equality rows; the spread
    is narrowed in float32 to keep the factorization well-conditioned."""
    eq_fac, loose_fac = (1e2, 1e-2) if _is_f32(l.dtype) else (1e3, 1e-6)
    is_eq = (u - l) <= 1e-12
    loose = torch.isinf(l) & torch.isinf(u)
    r = torch.where(is_eq, torch.full_like(l, rho * eq_fac),
                    torch.full_like(l, rho))
    return torch.where(loose, torch.full_like(l, rho * loose_fac), r)


def solve_qp(P, q, A, l, u, iters: int = 400, rho: float = 0.1,
             sigma: float | None = None, alpha: float = 1.6,
             polish: bool = True, adapt_every: int = 100,
             eps: float | None = None, exit_eps: float = 0.0) -> QPSolution:
    """Solve a batch of dense QPs with ``iters`` fixed ADMM trips.

    One KKT factorization ``M = P + sigma I + A' diag(rho) A`` per rho-stage
    (OSQP, Stellato et al. 2020), ``rho`` rescaled from the residual ratio
    every ``adapt_every`` trips, then the fixed-shape polish.

    ``exit_eps > 0`` (with more than one stage) is the JAX package's
    stage-granular early exit, per lane: a lane whose residuals after a
    stage are both at most ``exit_eps`` runs no later stage
    (:func:`morbit_tpu_torch.ops.qp_lane.admm_stages_exit`). At 0, the
    default, every lane runs the fixed trips."""
    nv = q.shape[-1]
    m = A.shape[-2]
    dtype = q.dtype
    f32 = _is_f32(dtype)
    # ---- row equilibration (OSQP scales its data by default, Stellato et
    # al. 2020 §5.1): mixed-scale rows stall the fixed-budget ADMM. The
    # row classification for the per-row penalty uses the ORIGINAL bounds.
    r_eq = A.abs().amax(-1) if m else torch.ones_like(l)
    r_eq = torch.where(r_eq > 0, r_eq, torch.ones_like(r_eq))
    rho_v0 = _rho_vec(l, u, rho)
    A = (A / r_eq[..., None]).contiguous()
    l = l / r_eq
    u = u / r_eq
    if sigma is None:
        sigma = 1e-4 if f32 else 1e-6
    if eps is None:
        eps = 1e-6 if f32 else 1e-8
    rho_lo, rho_hi = (1e-3, 1e4) if f32 else (1e-6, 1e6)

    n_stages = max(1, iters // adapt_every)
    stage_kw = dict(n_stages=n_stages, n_steps=min(adapt_every, iters),
                    sigma=float(sigma), alpha=float(alpha), rho_lo=rho_lo,
                    rho_hi=rho_hi)
    data = (P.contiguous(), q.contiguous(), A, l.contiguous(), u.contiguous(),
            rho_v0.contiguous())
    if exit_eps and n_stages > 1:
        z, zz, y, _ = qp_lane.admm_stages_exit(*data, exit_eps=float(exit_eps),
                                               **stage_kw)
    else:
        z, zz, y = qp_lane.admm_stages(*data, **stage_kw)

    if polish:
        z, y = _polish(P, q, A, l, u, z, y, delta=1e-5 if f32 else 1e-8)

    Az = _mv(A, z)
    viol = torch.clamp(Az - u, min=0.0) + torch.clamp(l - Az, min=0.0)
    prim_res = viol.amax(-1) if m else torch.zeros_like(q[..., 0])
    dual_res = (_mv(P, z) + q + _mv(A.transpose(-1, -2), y)).abs().amax(-1)
    obj = 0.5 * (z * _mv(P, z)).sum(-1) + (q * z).sum(-1)
    ok = (prim_res <= 1e3 * eps ** 0.5) & torch.isfinite(z).all(-1)
    # dual back in the caller's (unequilibrated) row scale
    y = y / r_eq
    return QPSolution(z, y, obj, prim_res, dual_res, ok)


def _polish(P, q, A, l, u, z, y, delta: float = 1e-8, refine_steps: int = 3):
    """Fixed-shape active-set polish (OSQP 'polish' analogue).

    Active rows are read from the ADMM dual signs; the equality-constrained
    KKT system keeps all rows, inactive ones disabled by a diagonal switch::

        [ P + dI    A' D ] [x  ]   [ -q      ]
        [ D A      -E    ] [nu ] = [ D b_act ]

    with ``D = diag(active)`` and ``E = d*I + diag(1-active)``; a few
    iterative-refinement steps recover the regularization's loss."""
    dtype = q.dtype
    n = q.shape[-1]
    m = A.shape[-2]
    At = A.transpose(-1, -2)

    Az = _mv(A, z)
    gap = torch.clamp(u - l, min=0.0)
    tol = 1e-6 * (1.0 + Az.abs())
    low_active = (y < -1e-10) | (Az <= l + tol)
    upp_active = (y > 1e-10) | (Az >= u - tol)
    is_eq = gap <= 1e-12
    fin_l, fin_u = torch.isfinite(l), torch.isfinite(u)
    active = (low_active & fin_l) | (upp_active & fin_u) | is_eq
    b_act = torch.where(is_eq, l, torch.where(upp_active & fin_u, u, l))
    b_act = torch.where(torch.isfinite(b_act), b_act, torch.zeros_like(b_act))
    act = active.to(dtype)

    DA = A * act[..., None]
    eye_n = torch.eye(n, dtype=dtype, device=q.device)
    K = torch.cat([
        torch.cat([P + delta * eye_n, DA.transpose(-1, -2)], dim=-1),
        torch.cat([DA, torch.diag_embed(-(delta * act + (1.0 - act)))],
                  dim=-1),
    ], dim=-2)
    rhs = torch.cat([-q, act * b_act], dim=-1)

    if _is_f32(dtype) and K.shape[-1] <= 2 * GJ_MAX_K:
        # unrolled inverse once; refinement applications become matvecs
        Kinv = gj_inverse(K)
        solve_K = lambda v: _mv(Kinv, v)
    elif dtype == torch.float64 and K.device.type != "cpu":
        # K6 on the card: its bits do not depend on the batch width (3.15)
        LU, perm, _ = lane_linalg.lane_lu_factor_cuda(
            K.reshape(-1, *K.shape[-2:]).contiguous())
        solve_K = lambda v: lane_linalg.lane_lu_solve_cuda(
            LU, perm, v.reshape(-1, v.shape[-1])).reshape(v.shape)
    else:
        LU, piv, _ = torch.linalg.lu_factor_ex(K)
        solve_K = lambda v: torch.linalg.lu_solve(LU, piv, v[..., None])[..., 0]
    sol = solve_K(rhs)

    # iterative refinement against the *unregularized* KKT operator
    def kkt_mv(v):
        x, nu = v[..., :n], v[..., n:]
        return torch.cat([_mv(P, x) + _mv(DA.transpose(-1, -2), nu),
                          _mv(DA, x) - (1.0 - act) * nu], dim=-1)

    for _ in range(refine_steps):
        sol = sol + solve_K(rhs - kkt_mv(sol))

    z_pol = sol[..., :n]
    y_pol = act * sol[..., n:]

    def merit(zc, yc):
        Azc = _mv(A, zc)
        dr = (_mv(P, zc) + q + _mv(At, yc)).abs().amax(-1)
        if not m:
            return dr
        pr = (torch.clamp(Azc - u, min=0.0)
              + torch.clamp(l - Azc, min=0.0)).amax(-1)
        return pr + dr

    better = (merit(z_pol, y_pol) <= merit(z, y)) & torch.isfinite(z_pol).all(-1)
    z_out = torch.where(better[..., None], z_pol, z)
    y_out = torch.where(better[..., None], y_pol, y)
    return z_out, y_out
