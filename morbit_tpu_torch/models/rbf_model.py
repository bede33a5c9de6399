"""RBF surrogate models: training-set selection (Wild's ORBIT rounds) + fit.

Counterpart of ``morbit_tpu/models/rbf_model.py`` (reference
``src/models/RbfModel.jl``), batched over lanes. Rounds 1-3 of the
training-set construction (``RbfModel.jl:518-655``) run as kernel K2 and
round 4 (``:352-499``) as kernel K3, both routed by
:mod:`morbit_tpu_torch.ops.prepare_fused`; the fit is the masked batched KKT
solve of :mod:`morbit_tpu_torch.ops.rbf`. Model improvement steps
(``:699-732``) consume one stored improving direction per call. With
``use_max_points`` round 4 also tries ``10 * max_points`` random in-box
candidates after the database rows, drawn from the context's key as the
JAX package draws them (:mod:`morbit_tpu_torch.ops.prng`); the ones it
accepts become new unevaluated sites.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from morbit_tpu_torch.core import database as dbm
from morbit_tpu_torch.models.base import ModelContext, SurrogateOps
from morbit_tpu_torch.ops import prepare_fused, prng
from morbit_tpu_torch.ops.geometry import intersect_box, local_bounds
from morbit_tpu_torch.ops.prepare_coord import round3_proposal
from morbit_tpu_torch.ops.rbf import (EXPONENT_KERNELS, RbfFit, eval_rbf,
                                      fit_rbf, kernel_default_param, poly_dim,
                                      rbf_jacobian)


class RbfState(NamedTuple):
    """Batched RBF model state (the JAX package packs the integers into one
    ``meta`` vector for its loop carries; ``utils/carry.py`` converts)."""

    idx: torch.Tensor           # (B, cap_train) int32 db rows of the training set
    n_train: torch.Tensor       # (B,) int32
    fully_linear: torch.Tensor  # (B,) bool
    dirs_head: torch.Tensor     # (B,) int32 next improving direction
    dirs_count: torch.Tensor    # (B,) int32 valid improving directions
    dirs: torch.Tensor          # (B, n, n) improving directions (rows)
    fit: RbfFit


def _masked_append(buf, count, src, src_count):
    """Place ``src[:, :src_count]`` at ``buf[:, count:count+src_count]`` per
    lane; returns the buffer and the new count."""
    slots = torch.arange(buf.shape[-1], device=buf.device)
    k = slots[None, :] - count[:, None]                     # (B, cap_train)
    take = (k >= 0) & (k < src_count[:, None])
    sel = take[..., None] & (k[..., None] == torch.arange(src.shape[-1],
                                                          device=buf.device))
    vals = torch.where(sel, src[:, None, :], 0).sum(-1).to(buf.dtype)
    return torch.where(take, vals, buf), (count + src_count).to(torch.int32)


class RbfOps(SurrogateOps):
    def __init__(self, group, n_vars, dtype, ac):
        super().__init__(group, n_vars, dtype, ac)
        cfg = self.cfg
        self.max_points = cfg.resolved_max_points(n_vars)
        # rounds 1-4 fill at most max(max_points, n+1) rows, and up to n
        # improvement steps may append before the next prepare resets the
        # set (a buffer of max_points alone let an improve step overwrite
        # the last training row, rbf_model.py:261-270 of the JAX package)
        self.cap_train = max(self.max_points, n_vars + 1) + n_vars
        self.train_stamp_len = self.cap_train + 1
        #: random round-4 candidates (``use_max_points``, ``RbfModel.jl:408-417``)
        self.n_rand = 10 * self.max_points if cfg.use_max_points else 0
        self.eval_window = n_vars + 1 + self.n_rand
        self.kernel = cfg.kernel
        self.poly_deg = cfg.polynomial_degree
        self.pd = poly_dim(n_vars, self.poly_deg)
        sp = cfg.shape_parameter
        if callable(sp):
            self._param_fn, self._static_param = sp, None
        elif isinstance(sp, float) and math.isnan(sp):
            self._param_fn, self._static_param = None, kernel_default_param(cfg.kernel)
        else:
            self._param_fn, self._static_param = None, sp
        self._sel_statics = dict(
            theta_e1=cfg.theta_enlarge_1,
            theta_e2_dmax=cfg.theta_enlarge_2 * ac.delta_max,
            theta_pivot=cfg.theta_pivot,
            delta_max=ac.delta_max,
            skip2_same_theta=cfg.theta_enlarge_1 == cfg.theta_enlarge_2)

    def _resolve_param(self, delta):
        """Shape parameter, possibly Delta-dependent (``RbfModel.jl:665-690``):
        a number, or a (B,) tensor from a callable."""
        if self._param_fn is not None:
            return torch.as_tensor(self._param_fn(delta), dtype=self.dtype,
                                   device=delta.device).expand(delta.shape)
        return self._static_param

    def init_state(self, B: int, device):
        n, m, dt = self.n_vars, self.group.m, self.dtype
        i32 = torch.int32
        P = self.cap_train
        zeros_i = lambda: torch.zeros((B,), dtype=i32, device=device)
        return RbfState(
            idx=torch.zeros((B, P), dtype=i32, device=device),
            n_train=zeros_i(),
            fully_linear=torch.zeros((B,), dtype=torch.bool, device=device),
            dirs_head=zeros_i(), dirs_count=zeros_i(),
            dirs=torch.zeros((B, n, n), dtype=dt, device=device),
            fit=RbfFit(sites=torch.zeros((B, P, n), dtype=dt, device=device),
                       mask=torch.zeros((B, P), dtype=torch.bool, device=device),
                       w=torch.zeros((B, P, m), dtype=dt, device=device),
                       lam=torch.zeros((B, self.pd, m), dtype=dt, device=device),
                       param=torch.zeros((B,), dtype=dt, device=device)))

    # ------------------------------------------------------------------ phase 1
    def _boxes(self, ctx: ModelContext):
        cfg, dt = self.cfg, self.dtype
        delta_1 = torch.tensor(cfg.theta_enlarge_1, dtype=dt) * ctx.delta
        lb1, ub1 = local_bounds(ctx.x_s, delta_1, ctx.scal.lb_scaled,
                                ctx.scal.ub_scaled)
        piv1 = torch.tensor(cfg.theta_pivot, dtype=dt) * delta_1
        delta_2 = torch.tensor(cfg.theta_enlarge_2 * self.ac.delta_max, dtype=dt)
        lb2, ub2 = local_bounds(ctx.x_s, delta_2, ctx.scal.lb_scaled,
                                ctx.scal.ub_scaled)
        return lb1, ub1, piv1, lb2, ub2

    def prepare(self, state, db, ctx: ModelContext, ensure_fully_linear):
        """Rounds 1-4 (``RbfModel.jl:518-655``); ``ensure_fully_linear`` is
        a bool or a (B,) per-lane flag."""
        cfg, n, dt = self.cfg, self.n_vars, self.dtype
        x = ctx.x_s
        B, dev = x.shape[0], x.device
        i32 = torch.int32
        lb1, ub1, piv1, lb2, ub2 = self._boxes(ctx)
        num_unevaluated = (dbm.valid_mask(db) & ~db.evaluated).sum(-1, dtype=i32)
        budget = min(self.ac.max_evals, self.group.max_evals)
        max_new = (torch.tensor(budget, dtype=i32, device=dev) - 1 - ctx.n_evals
                   - num_unevaluated).to(i32)

        if cfg.optimized_sampling:
            efl = torch.as_tensor(ensure_fully_linear, device=dev).expand(B).contiguous()
            dense = lambda t: t.contiguous()
            (r1_idx, r1_cnt, r2_idx, r2_cnt, sites3, active3, n_new, dirs,
             dirs_count, fully_linear) = prepare_fused.selection(
                db.X, db.count, dense(x), dense(ctx.x_index.to(i32)),
                dense(ctx.delta), dense(ctx.scal.lb_scaled),
                dense(ctx.scal.ub_scaled), max_new, efl, **self._sel_statics)
        else:
            # non-optimized sampling: always rebuild along the coordinate
            # axes (``RbfModel.jl:564-570``; rounds 2 and 4 skipped)
            r1_idx = r2_idx = torch.full((B, n), -1, dtype=i32, device=dev)
            r1_cnt = r2_cnt = torch.zeros((B,), dtype=i32, device=dev)
            dirs = torch.eye(n, dtype=dt, device=dev).expand(B, n, n)
            full = torch.full((B,), n, dtype=i32, device=dev)
            dirs_count = full
            sites3, active3, ok3, _, covers3, n_new = round3_proposal(
                x, dirs, full, max_new, lb1, ub1, piv1)
            fully_linear = covers3 & (ok3 | ~active3).all(-1)

        # ---- round-3 sites enter the database unevaluated
        r3 = []
        for i in range(n):
            db, new_id = dbm.add_site(db, sites3[:, i], active3[:, i])
            r3.append(new_id)
        r3_idx = torch.stack(r3, dim=-1)

        # ---- training indices: [center; r1; r2; r3]
        idx = torch.zeros((B, self.cap_train), dtype=i32, device=dev)
        idx[:, 0] = ctx.x_index
        count = torch.ones((B,), dtype=i32, device=dev)
        idx, count = _masked_append(idx, count, r1_idx, r1_cnt)
        idx, count = _masked_append(idx, count, r2_idx, r2_cnt)
        idx, count = _masked_append(idx, count, r3_idx, n_new)

        if cfg.optimized_sampling and self.max_points > n + 1:
            db, idx, count = self._round4(db, idx, count, lb2, ub2, ctx)

        return state._replace(idx=idx, n_train=count,
                              fully_linear=fully_linear.to(torch.bool),
                              dirs=dirs.contiguous(), dirs_head=n_new.to(i32),
                              dirs_count=dirs_count.to(i32)), db

    def _round4(self, db, idx, count, lb2, ub2, ctx):
        """Accept extra in-box database rows while the Cholesky factor of
        ``Z' Phi Z`` stays bounded (``_rbf_round4``, ``RbfModel.jl:352-499``).
        The candidates are the database rows and, with ``use_max_points``,
        ``n_rand`` random in-box points after them; the first ``scan_cap =
        min(cap, 10 max_points) + n_rand`` are scanned, as in the JAX package
        (rbf_model.py:546-551): past ``10 max_points`` rows the scan ends
        inside the database and the random points are not reached. Returns
        the database (the accepted random points appended unevaluated), the
        training rows and their count."""
        cap = db.data.shape[-2]
        dev = idx.device
        C = min(cap, 10 * self.max_points) + self.n_rand
        X = db.X[:, :min(C, cap)]
        rows = torch.arange(X.shape[1], device=dev)
        in_box = (((X >= lb2[:, None, :]) & (X <= ub2[:, None, :])).all(-1)
                  & (rows[None, :] < db.count[:, None]))
        live = torch.arange(self.cap_train, device=dev)[None, :] < count[:, None]
        in_training = ((rows[None, :, None] == idx[:, None, :])
                       & live[:, None, :]).any(-1)
        cand = in_box & ~in_training
        if C > cap:
            u = prng.uniform(ctx.key, (self.n_rand, self.n_vars), self.dtype)
            rand = (lb2[:, None, :] + (ub2 - lb2)[:, None, :] * u)[:, :C - cap]
            X = torch.cat([X, rand], dim=1)
            cand = torch.cat([cand, torch.ones_like(cand[:, :1]).expand(-1, C - cap)], 1)
        init_sites, _ = dbm.get_rows(db, idx)
        param = self._resolve_param(ctx.delta)
        if self.kernel in EXPONENT_KERNELS:
            param = self._static_param
        elif isinstance(param, torch.Tensor):
            param = param.contiguous()
        else:
            param = torch.full_like(ctx.delta, float(param))
        accepted, _ = prepare_fused.round4(
            X, cand.contiguous(), init_sites.contiguous(), count,
            kernel=self.kernel, param=param, poly_deg=self.poly_deg,
            max_points=self.max_points,
            chol_pivot=self.cfg.theta_pivot_cholesky ** 2)
        # append accepted rows in database order: slot j takes the row whose
        # acceptance rank lands on j
        acc_db = accepted[:, :cap]
        pos = count[:, None] + torch.cumsum(acc_db.to(torch.int32), -1) - 1
        slots = torch.arange(self.cap_train, device=dev)
        match = acc_db[:, None, :] & (pos[:, None, :] == slots[None, :, None])
        row_for_slot = torch.argmax(match.to(torch.int32), dim=-1).to(torch.int32)
        idx = torch.where(match.any(-1), row_for_slot, idx)
        count = (count + acc_db.sum(-1, dtype=torch.int32)).to(torch.int32)
        if C > cap:
            # the accepted random points become new sites in order, each
            # taking the next training slot (rbf_model.py:565-582)
            acc_r = accepted[:, cap:]
            db, new_id = dbm.add_sites(db, X[:, cap:], acc_r)
            slot = torch.clamp(count[:, None] + torch.cumsum(acc_r.to(torch.int32), -1) - 1,
                               0, self.cap_train - 1)
            match = acc_r[:, None, :] & (slot[:, None, :] == slots[None, :, None])
            # the last write to a slot wins, as in the sequential loop
            last = match.shape[-1] - 1 - torch.argmax(match.flip(-1).to(torch.int32), dim=-1)
            idx = torch.where(match.any(-1), torch.gather(new_id, 1, last), idx)
            count = (count + acc_r.sum(-1, dtype=torch.int32)).to(torch.int32)
        return db, idx, count

    def prepare_with_reuse(self, state, db, ctx: ModelContext, other_state,
                           other_db):
        """Take the rounds-1-3 point set of an earlier RBF group with the
        same geometry signature (``_exploit_other_rbf_metas!``,
        ``RbfModel.jl:311-342``), locating each site in (or adding it to)
        this group's database by exact match, then run round 4 here."""
        n = self.n_vars
        B, dev = ctx.x_s.shape[0], ctx.x_s.device
        i32 = torch.int32
        cap = db.data.shape[-2]
        idx = torch.zeros((B, self.cap_train), dtype=i32, device=dev)
        idx[:, 0] = ctx.x_index
        n_13 = torch.clamp(other_state.n_train, max=n + 1)
        for i in range(1, n + 1):
            do = i < n_13
            src = torch.clamp(other_state.idx[:, i], 0, cap - 1).long()
            site = torch.gather(other_db.X, 1, src[:, None, None].expand(B, 1, n))[:, 0]
            hits = (db.X == site[:, None, :]).all(-1) & dbm.valid_mask(db)
            found = hits.any(-1)
            found_id = torch.argmax(hits.to(i32), dim=-1).to(i32)
            db, new_id = dbm.add_site(db, site, do & ~found)
            use_id = torch.where(found, found_id, new_id)
            idx[:, i] = torch.where(do, use_id, idx[:, i])
        state = state._replace(idx=idx, n_train=n_13.to(i32),
                               fully_linear=other_state.fully_linear,
                               dirs=other_state.dirs,
                               dirs_head=other_state.dirs_head,
                               dirs_count=other_state.dirs_count)
        if self.cfg.optimized_sampling and self.max_points > n + 1:
            _, _, _, lb2, ub2 = self._boxes(ctx)
            db, idx, count = self._round4(db, state.idx, state.n_train, lb2, ub2, ctx)
            state = state._replace(idx=idx, n_train=count)
        return state, db

    # ------------------------------------------------------------------ improve
    def prepare_improve(self, state, db, ctx: ModelContext):
        """One new site along the next improving direction (``:699-732``).
        The direction is consumed even when the pivot test fails, as the
        reference's ``popfirst!`` precedes the test."""
        x = ctx.x_s
        B, n = x.shape
        do = ~state.fully_linear & (state.dirs_head < state.dirs_count)
        lb1, ub1, piv1, _, _ = self._boxes(ctx)
        head = torch.clamp(state.dirs_head, 0, n - 1).long()
        d = torch.gather(state.dirs, 1, head[:, None, None].expand(B, 1, n))[:, 0]
        ln = intersect_box(x, d, lb1, ub1, ret_mode="absmax")
        offset = ln[:, None] * d
        success = do & (offset.abs().amax(-1) > piv1)
        db, new_id = dbm.add_site(db, x + offset, success)
        slot = torch.clamp(state.n_train, 0, self.cap_train - 1)
        hit = success[:, None] & (torch.arange(self.cap_train, device=x.device)[None, :]
                                  == slot[:, None])
        idx = torch.where(hit, new_id[:, None], state.idx)
        n_train = torch.where(success, state.n_train + 1, state.n_train)
        new_head = torch.where(do, state.dirs_head + 1, state.dirs_head)
        fl = torch.where(success & (new_head >= state.dirs_count), True,
                         state.fully_linear)
        return state._replace(idx=idx, n_train=n_train, dirs_head=new_head,
                              fully_linear=fl), db

    # ------------------------------------------------------------------ phase 2
    def fit(self, state, db, ctx: ModelContext):
        mask = (torch.arange(self.cap_train, device=state.idx.device)[None, :]
                < state.n_train[:, None])
        sites, values = dbm.get_rows(db, state.idx)
        fit = fit_rbf(sites, values, mask, kernel=self.kernel,
                      param=self._resolve_param(ctx.delta),
                      poly_deg=self.poly_deg)
        return state._replace(fit=fit)

    # ------------------------------------------------------------------- eval
    def _eval_param(self, state):
        if self.kernel in EXPONENT_KERNELS:
            return self._static_param
        return state.fit.param

    def eval(self, state, x_s, scal=None):
        return eval_rbf(state.fit, x_s, self.kernel, self.poly_deg,
                        param=self._eval_param(state))

    def jac(self, state, x_s, scal=None):
        return rbf_jacobian(state.fit, x_s, self.kernel, self.poly_deg,
                            param=self._eval_param(state))

    def fully_linear(self, state):
        return state.fully_linear

    def set_fully_linear(self, state, val):
        """``val``: a bool, or a (B,) mask of the lanes' new flags."""
        flag = torch.as_tensor(val, device=state.fully_linear.device)
        return state._replace(fully_linear=flag.expand_as(state.fully_linear).clone())

    def train_stamp(self, state):
        """``[n_train, idx...]``: which db rows built this model
        (``RbfModel.jl:162-175``)."""
        return torch.cat([state.n_train[:, None], state.idx], dim=-1)
