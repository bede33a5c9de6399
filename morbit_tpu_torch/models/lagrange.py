"""Lagrange interpolation surrogates (degree 1/2), batched over lanes.

Counterpart of ``morbit_tpu/models/lagrange.py`` (reference
``src/models/LagrangeModel.jl``). Polynomials are coefficient vectors over
the canonical monomial basis (``LagrangeModel.jl:163-175``), so the
Lagrange basis of a lane is a (p, p) matrix:

* Algorithm 6.2 of Conn et al. (``:217-288``) picks, for each basis
  polynomial, the candidate maximizing ``|l_i|``; where no candidate
  passes, ``|l_i|`` is maximized over ``[0,1]^n`` by a grid sweep and
  projected gradient ascent (:mod:`morbit_tpu_torch.ops.boxopt`, in place
  of NLopt's BOBYQA);
* Algorithm 6.3 (``:310-382``) swaps points until the set is
  Lambda-poised, as one loop masked per lane by its own ``done`` flag;
* basis orthogonalization (``:184-190``) is a rank-1 update per lane.

The set lives in ``[0,1]^n`` relative to the enlarged trust-region box and
its new points are added to the database in one write (``_consume_points``,
``:444-462``). The dot products over the basis add in index order with
one rounding per operation, so the card and the CPU take the same greedy
ascent steps.
"""

from __future__ import annotations

import itertools
import os
import pathlib
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from morbit_tpu_torch.core import database as dbm
from morbit_tpu_torch.models.base import ModelContext, SurrogateOps
from morbit_tpu_torch.ops.batched_linalg import lane_product
from morbit_tpu_torch.ops.boxopt import first_argmax, halton_grid, maximize_in_box
from morbit_tpu_torch.ops.geometry import local_bounds

#: skip, with one host check each, the ascents of an Algorithm 6.2 pick
#: that no active lane needs and the Algorithm 6.3 passes once every lane
#: is done; the results are the same either way
SKIP_IDLE_ASCENTS = True


def monomial_exponents(n_vars: int, degree: int) -> np.ndarray:
    """Exponent rows of the canonical basis of ``Pi_n^d`` in degree-ascending
    order (``non_negative_ineq_solutions``, ``LagrangeModel.jl:163-166``)."""
    rows = []
    for d in range(degree + 1):
        for combo in itertools.combinations_with_replacement(range(n_vars), d):
            e = np.zeros(n_vars, dtype=np.int32)
            for i in combo:
                e[i] += 1
            rows.append(e)
    return np.stack(rows) if rows else np.zeros((1, n_vars), np.int32)


def _dot(a, b):
    """``sum(a * b, -1)`` added in index order."""
    prod = a * b
    acc = prod[..., 0]
    for i in range(1, prod.shape[-1]):
        acc = acc + prod[..., i]
    return acc


def _set_row(M, i, row):
    """``M`` (L, p, ...) with row ``i`` (an int or an (L,) tensor) replaced
    by ``row`` (L, ...)."""
    p = M.shape[1]
    rows = torch.arange(p, device=M.device)
    hit = (rows == i)[None] if isinstance(i, int) else rows == i[:, None]
    hit = hit.reshape(hit.shape + (1,) * (M.dim() - 2))
    return torch.where(hit, row[:, None], M)


class LagrangeState(NamedTuple):
    B: torch.Tensor            # (L, p, p) Lagrange basis coefficients over monomials
    coef: torch.Tensor         # (L, p, m) interpolation coefficients (B^T Y)
    idx: torch.Tensor          # (L, p) int32 db rows of the poised points
    lb: torch.Tensor           # (L, n) box of the [0,1]^n parametrization
    ub: torch.Tensor
    fully_linear: torch.Tensor  # (L,) bool


class LagrangeOps(SurrogateOps):
    #: static stamps, (points, B) as float64 numpy, per construction key
    _stamp_cache: dict = {}

    def __init__(self, group, n_vars, dtype, ac):
        super().__init__(group, n_vars, dtype, ac)
        cfg = self.cfg
        self.E = monomial_exponents(n_vars, cfg.degree)      # (p, n)
        self.p = self.E.shape[0]
        self.grid = halton_grid(min(50 * n_vars, 512), n_vars)
        # the JAX package's tolerance, from the float64 and float16
        # epsilons whatever the working precision
        self.zero_tol = float(min(np.finfo(np.float64).eps * 100,
                                  np.finfo(np.float16).eps * 10))
        self.lambda_max_loops = 2 * self.p
        self.eval_window = self.p
        self._consts = {}
        if not cfg.optimized_sampling:
            self._static_stamp()

    # ---- polynomial helpers ----------------------------------------------------
    def _const(self, name, device, dtype=None):
        """The exponents (``E``) or the sweep grid (``grid``) on ``device``,
        copied there once."""
        key = (name, device, dtype)
        if key not in self._consts:
            self._consts[key] = torch.as_tensor(getattr(self, name), dtype=dtype,
                                                device=device)
        return self._consts[key]

    def _terms(self, u):
        """Per-monomial factors (..., p, n): 1, u_j or u_j^2 (integer powers
        spelled out, as the JAX package does)."""
        E = self._const("E", u.device)
        ub = u[..., None, :]
        return torch.where(E == 0, torch.ones_like(ub), torch.where(E == 1, ub, ub * ub))

    def _phi(self, u):
        """Monomial values at points ``u (..., n)`` -> ``(..., p)``."""
        t = self._terms(u)
        out = t[..., 0]
        for j in range(1, t.shape[-1]):
            out = out * t[..., j]
        return out

    def _others(self, t):
        """Product over the other variables' factors, (..., p, n)."""
        n = t.shape[-1]
        cols = []
        for j in range(n):
            acc = torch.ones_like(t[..., 0])
            for i in range(n):
                if i != j:
                    acc = acc * t[..., i]
            cols.append(acc)
        return torch.stack(cols, dim=-1)

    def _dphi(self, u):
        """Monomial derivatives ``d phi / du`` at ``u (..., n)`` -> ``(..., p, n)``."""
        E = self._const("E", u.device)
        t = self._terms(u)
        ub = u[..., None, :]
        d = torch.where(E == 0, torch.zeros_like(ub), torch.where(E == 1, torch.ones_like(ub),
                                                                   ub + ub))
        return d * self._others(t)

    def _abs_grad(self, b, U):
        """Gradient of ``|b . phi(u)|`` at ``U (L, k, n)`` for rows ``b (L, p)``,
        in the order reverse-mode autodiff takes it: the sign (+1 at a zero,
        as ``jax.grad`` of ``abs``) times ``b_k`` times the other factors,
        through ``u^2`` as ``c u + c u``, summed over the monomials in index
        order."""
        E = self._const("E", U.device)
        s = torch.where(_dot(b[:, None, :], self._phi(U)) >= 0, 1.0, -1.0).to(U.dtype)
        c = (s[..., None] * b[:, None, :])[..., None] * self._others(self._terms(U))
        ub = U[..., None, :]
        contrib = torch.where(E == 0, torch.zeros_like(c),
                              torch.where(E == 1, c, c * ub + c * ub))
        acc = contrib[..., 0, :]
        for k in range(1, contrib.shape[-2]):
            acc = acc + contrib[..., k, :]
        return acc

    def _orthogonalize(self, B, u, i):
        """Normalize row i (an int or (L,) rows) at u (L, n) and sweep it out
        of the other rows (``orthogonalize_polys``, ``LagrangeModel.jl:184-190``)."""
        vals = _dot(B, self._phi(u)[:, None, :])              # (L, p)
        if isinstance(i, int):
            denom, bi = vals[:, i], B[:, i]
        else:
            lanes = torch.arange(B.shape[0], device=B.device)
            denom, bi = vals[lanes, i], B[lanes, i]
        denom = torch.where(denom.abs() > 0, denom, torch.ones_like(denom))
        bi = bi / denom[:, None]
        return _set_row(B - vals[:, :, None] * bi[:, None, :], i, bi)

    def _maximize_abs(self, b, extra_starts=None):
        """max |l(u)| over [0,1]^n per row ``b (L, p)`` by the grid sweep and
        ``ascent_restarts`` concurrent ascents (the BOBYQA replacement)."""
        L, n = b.shape[0], self.n_vars
        f = lambda U: _dot(b[:, None, :], self._phi(U)).abs()
        lb = torch.zeros((L, n), dtype=b.dtype, device=b.device)
        return maximize_in_box(f, lb, torch.ones_like(lb),
                               self._const("grid", b.device, b.dtype),
                               iters=self.cfg.ascent_iters, extra_starts=extra_starts,
                               n_starts=self.cfg.ascent_restarts,
                               grad=lambda U: self._abs_grad(b, U))

    # ---- state ---------------------------------------------------------------
    def init_state(self, B: int, device):
        n, m, p, dt = self.n_vars, self.group.m, self.p, self.dtype
        return LagrangeState(
            B=torch.eye(p, dtype=dt, device=device).expand(B, p, p).clone(),
            coef=torch.zeros((B, p, m), dtype=dt, device=device),
            idx=torch.zeros((B, p), dtype=torch.int32, device=device),
            lb=torch.zeros((B, n), dtype=dt, device=device),
            ub=torch.ones((B, n), dtype=dt, device=device),
            fully_linear=torch.zeros((B,), dtype=torch.bool, device=device))

    # ---- static stamp (optimized_sampling=False) -------------------------------
    def _stamp_file(self):
        """Where the stamp is saved and looked up: the JAX package's file
        name and ``.npz`` layout (``points``, ``B``), tagged with the
        working precision, so that a stamp either package wrote is found
        by both (``LagrangeModel.jl:77-80,537-573``)."""
        c = self.cfg
        if c.save_path is None:
            return None
        prec = 64 if self.dtype == torch.float64 else 32
        name = (f"lagrange_stamp_n{self.n_vars}_d{c.degree}_lam{c.lambda_poise:g}"
                f"_r{c.ascent_restarts}_i{c.ascent_iters}_f{prec}.npz")
        return pathlib.Path(c.save_path) / name

    def _static_stamp(self):
        """One fixed Lambda-poised set in [0,1]^n and its basis, built once
        per process on the CPU at the working precision (it does not depend
        on the problem), and with ``save_path`` kept on disk; writes are
        atomic (a temporary file and a rename)."""
        c = self.cfg
        key = (self.n_vars, c.degree, c.lambda_poise, c.ascent_restarts, c.ascent_iters,
               self.dtype, c.save_path)
        if key in LagrangeOps._stamp_cache:
            return LagrangeOps._stamp_cache[key]
        path = self._stamp_file()
        if path is not None and path.exists():
            with np.load(path) as dat:
                stamp = (np.asarray(dat["points"], np.float64),
                         np.asarray(dat["B"], np.float64))
            LagrangeOps._stamp_cache[key] = stamp
            return stamp

        p, n = self.p, self.n_vars
        B = torch.eye(p, dtype=self.dtype)[None]
        points = torch.zeros((1, p, n), dtype=self.dtype)
        # Algorithm 6.2 from the single candidate 0.5^n (``:537-546``)
        cand = torch.full((1, n), 0.5, dtype=self.dtype)
        phis = self._phi(cand)
        avail = True
        for i in range(p):
            val = _dot(phis, B[:, i])[0].abs()
            if avail and bool(val > self.zero_tol):
                u_new = cand
                avail = False
            else:
                u_new, _ = self._maximize_abs(B[:, i])
            points = _set_row(points, i, u_new)
            B = self._orthogonalize(B, u_new, i)
        # Algorithm 6.3 swaps, the first polynomial past Lambda each pass
        for _ in range(self.lambda_max_loops):
            swapped = False
            for i in range(p):
                x_i, v_i = self._maximize_abs(B[:, i], extra_starts=points[:, i][:, None])
                if bool(v_i[0] > c.lambda_poise):
                    points = _set_row(points, i, x_i)
                    B = self._orthogonalize(B, x_i, i)
                    swapped = True
                    break
            if not swapped:
                break
        stamp = (points[0].double().numpy(), B[0].double().numpy())
        LagrangeOps._stamp_cache[key] = stamp
        if path is not None:
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as fh:
                    np.savez(fh, points=stamp[0], B=stamp[1])
                os.replace(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
        return stamp

    def _box(self, ctx: ModelContext):
        lb, ub = local_bounds(ctx.x_s, ctx.delta * self.cfg.theta_enlarge,
                              ctx.scal.lb_scaled, ctx.scal.ub_scaled)
        return lb, ub, ub - lb

    def _prepare_stamp(self, state, db, ctx: ModelContext):
        """Unoptimized sampling: the fixed stamp, unscaled into every lane's
        enlarged trust-region box, all of it added to the database."""
        lb, ub, w = self._box(ctx)
        pts_np, B_np = self._static_stamp()
        dev = ctx.x_s.device
        points = torch.as_tensor(pts_np, dtype=self.dtype, device=dev)
        L = lb.shape[0]
        sites = lb[:, None, :] + w[:, None, :] * points
        db, idx = dbm.add_sites(db, sites, torch.ones((L, self.p), dtype=torch.bool,
                                                      device=dev))
        B = torch.as_tensor(B_np, dtype=self.dtype, device=dev).expand(L, -1, -1).clone()
        return state._replace(B=B, idx=idx, lb=lb, ub=ub,
                              fully_linear=torch.ones_like(state.fully_linear)), db

    # ---- phase 1 ---------------------------------------------------------------
    def prepare(self, state, db, ctx: ModelContext, ensure_fully_linear):
        """``ensure_fully_linear``: a bool or an (L,) mask. With
        ``allow_not_linear`` only those lanes make their set Lambda-poised
        (and are then fully linear); otherwise every lane does. The JAX
        package's fixed-trip loop and its flag-gated while loop give the
        same values, and both are this one masked loop."""
        cfg = self.cfg
        if not cfg.optimized_sampling:
            return self._prepare_stamp(state, db, ctx)
        p, dt = self.p, self.dtype
        x = ctx.x_s
        L, dev = x.shape[0], x.device
        lanes = torch.arange(L, device=dev)
        active = (torch.ones(L, dtype=torch.bool, device=dev) if ctx.active is None
                  else ctx.active)
        lb, ub, w = self._box(ctx)

        # candidates: [x; db points in the box], scaled to [0,1]^n (``:493-496``)
        cap = db.data.shape[-2]
        in_box = dbm.results_in_box(db, lb, ub, exclude_index=ctx.x_index)
        avail = torch.cat([torch.ones((L, 1), dtype=torch.bool, device=dev), in_box], -1)
        cand_idx = torch.cat([ctx.x_index[:, None].to(torch.int32),
                              torch.arange(cap, dtype=torch.int32, device=dev)
                              .expand(L, cap)], -1)
        cand_unit = (torch.cat([x[:, None, :], db.X], 1) - lb[:, None, :]) / w[:, None, :]
        C = cand_unit.shape[1]

        # ---- Algorithm 6.2 (``get_poised_set``)
        B = torch.eye(p, dtype=dt, device=dev).expand(L, p, p).clone()
        phis = self._phi(cand_unit)                            # (L, C, p)
        points = torch.zeros((L, p, self.n_vars), dtype=dt, device=dev)
        src = torch.full((L, p), -1, dtype=torch.int32, device=dev)
        ninf = torch.full((), -float("inf"), dtype=dt, device=dev)
        for i in range(p):
            vals = torch.where(avail, _dot(phis, B[:, i][:, None, :]).abs(), ninf)
            j = first_argmax(vals)
            use_cand = vals[lanes, j] > self.zero_tol
            if SKIP_IDLE_ASCENTS and not bool((active & ~use_cand).any()):
                x_opt = torch.zeros_like(points[:, 0])
            else:
                x_opt, _ = self._maximize_abs(B[:, i])
            u_new = torch.where(use_cand[:, None], cand_unit[lanes, j], x_opt)
            points = _set_row(points, i, u_new)
            src = _set_row(src, i, torch.where(use_cand, cand_idx[lanes, j],
                                               torch.full_like(j, -1, dtype=torch.int32)))
            avail = avail & ~(use_cand[:, None]
                              & (torch.arange(C, device=dev) == j[:, None]))
            B = self._orthogonalize(B, u_new, i)

        # ---- Algorithm 6.3 (``make_set_lambda_poised``)
        if not cfg.allow_not_linear:
            efl = torch.ones((L,), dtype=torch.bool, device=dev)
        elif isinstance(ensure_fully_linear, torch.Tensor):
            efl = ensure_fully_linear.expand(L).clone()
        else:
            efl = torch.full((L,), bool(ensure_fully_linear), device=dev)
        done = ~efl
        pslots = torch.arange(p, device=dev)
        for _ in range(self.lambda_max_loops):
            if SKIP_IDLE_ASCENTS and not bool((active & ~done).any()):
                break
            xs, vs = self._maximize_abs(B.reshape(L * p, p),
                                        extra_starts=points.reshape(L * p, 1, -1))
            xs, vs = xs.reshape(L, p, -1), vs.reshape(L, p)
            exceeds = vs > cfg.lambda_poise
            # the reference discards the slot holding x last
            # (``skip_indices``, ``LagrangeModel.jl:511-515``)
            center_slot = first_argmax((src == cand_idx[:, :1]).to(dt))
            pri = exceeds & (pslots != center_slot[:, None])
            any_pri, any_exc = pri.any(-1), exceeds.any(-1)
            i_k = torch.where(any_pri, first_argmax(pri.to(dt)), first_argmax(exceeds.to(dt)))
            swap = any_exc & ~done
            u_new = xs[lanes, i_k]
            B = torch.where(swap[:, None, None], self._orthogonalize(B, u_new, i_k), B)
            points = torch.where(swap[:, None, None], _set_row(points, i_k, u_new), points)
            src = torch.where(swap[:, None], _set_row(src, i_k, torch.full_like(i_k, -1,
                                                                             dtype=torch.int32)),
                              src)
            done = done | ~any_exc

        # ---- the new points into the database (``_consume_points``)
        is_new = src < 0
        db, new_id = dbm.add_sites(db, lb[:, None, :] + w[:, None, :] * points, is_new)
        idx = torch.where(is_new, new_id, src)
        return state._replace(B=B, idx=idx, lb=lb, ub=ub, fully_linear=efl), db

    def prepare_improve(self, state, db, ctx: ModelContext):
        """Improvement is a rebuild that ensures Lambda-poisedness."""
        return self.prepare(state, db, ctx, ensure_fully_linear=True)

    def prepare_or_improve(self, state, db, ctx: ModelContext, improve_flag, efl_flag):
        """The per-lane choice between :meth:`prepare_improve` and
        :meth:`prepare` in one pass: each lane's result depends only on its
        own flag, and improvement is a rebuild with the flag set."""
        return self.prepare(state, db, ctx, improve_flag | efl_flag)

    # ---- phase 2 ---------------------------------------------------------------
    def fit(self, state, db, ctx: ModelContext):
        _, Y = dbm.get_rows(db, state.idx)                     # (L, p, m)
        return state._replace(coef=lane_product(state.B.transpose(-1, -2), Y))

    # ---- evaluation ------------------------------------------------------------
    def _lead(self, t, extra):
        return t.reshape(t.shape[:1] + (1,) * extra + t.shape[1:])

    def eval(self, state, x_s, scal=None):
        """Model values at sites ``x_s (L, ..., n)`` -> ``(L, ..., m)``."""
        extra = x_s.dim() - 2
        lb, ub = self._lead(state.lb, extra), self._lead(state.ub, extra)
        phi = self._phi((x_s - lb) / (ub - lb))
        return lane_product(phi[..., None, :], self._lead(state.coef, extra))[..., 0, :]

    def jac(self, state, x_s, scal=None):
        """(L, m, n) Jacobians, in closed form in the monomials."""
        w = state.ub - state.lb
        dphi = self._dphi((x_s - state.lb) / w)                # (L, p, n)
        return lane_product(state.coef.transpose(-1, -2), dphi) / w[:, None, :]

    def fully_linear(self, state):
        return state.fully_linear

    def set_fully_linear(self, state, val):
        """``val``: a bool, or an (L,) mask of the lanes' new flags."""
        flag = torch.as_tensor(val, device=state.fully_linear.device)
        return state._replace(fully_linear=flag.expand_as(state.fully_linear).clone())
