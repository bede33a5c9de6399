"""Surrogate container: grouped vector models + objective evaluation.

Counterpart of ``morbit_tpu/models/container.py`` (reference
``src/SurrogateContainer.jl``), batched over lanes, for exact, RBF, Taylor
and Lagrange groups. Group outputs map into the role vectors fx (objectives), c_e and
c_i (nonlinear equality and inequality constraints). Each group carries an
``n_evals`` counter per lane (the
``CountedFunc`` analogue, ``src/globals.jl:74-112``); exact groups also
count on *model* evaluation, because their model is the counted function.
An RBF group whose geometry signature equals an earlier RBF group's takes
that group's rounds-1-3 training set (``_exploit_other_rbf_metas!``,
``RbfModel.jl:311-342``). A composite ``phi(x, g(x))`` takes its value
``phi(untransform(x_s), m_g(x_s))`` from its inner group's model and its
Jacobian by the chain rule ``D_x phi diag(1/scale) + D_g phi J_m``.

A group with host functions (``VecFun.host``) is evaluated on the host at
the rows whose results are kept only: the lanes the caller names
(``active``), the sites not found in the database, the missing rows of
``eval_missing``. Torch groups are evaluated at every lane as before, their
results selected away where a lane discards them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from morbit_tpu_torch.core import database as dbm
from morbit_tpu_torch.core import scaling
from morbit_tpu_torch.core.mop import NL_EQ, NL_INEQ, OBJECTIVE, CompiledMOP
from morbit_tpu_torch.models.base import ModelContext
from morbit_tpu_torch.models.configs import (ExactConfig, LagrangeConfig, RbfConfig,
                                             TaylorConfig, check_ported)
from morbit_tpu_torch.models.exact import ExactOps, broadcast_scaler
from morbit_tpu_torch.models.lagrange import LagrangeOps
from morbit_tpu_torch.models.rbf_model import RbfOps
from morbit_tpu_torch.models.taylor import TaylorOps
from morbit_tpu_torch.ops import prng
from morbit_tpu_torch.utils.tree import tree_where


def chain_rule(d_x, d_g, J_inner):
    """``d_x + d_g @ J_inner`` for (..., n_out, n), (..., n_out, w) and
    (..., w, n), the product's terms added in index order, one rounding
    per operation: unlike a batched matrix product, the same bits at every
    batch width and on every device."""
    acc = d_x
    for k in range(d_g.shape[-1]):
        acc = acc + d_g[..., k:k + 1] * J_inner[..., k:k + 1, :]
    return acc


class GroupState(NamedTuple):
    db: dbm.Database
    model: object          # model-family-specific state (() for exact)
    n_evals: torch.Tensor  # (B,) int32


def make_ops(group, n_vars, dtype, ac):
    cfg = check_ported(group.cfg)
    family = {ExactConfig: ExactOps, RbfConfig: RbfOps, TaylorConfig: TaylorOps,
              LagrangeConfig: LagrangeOps}[type(cfg)]
    return family(group, n_vars, dtype, ac)


class SurrogateContainer:
    """Static container built once per solver."""

    def __init__(self, mop: CompiledMOP, dtype, ac, db_capacity: int, device):
        self.mop = mop
        self.dtype = dtype
        self.ac = ac
        self.db_capacity = db_capacity
        self.device = device
        self.ops = tuple(make_ops(g, mop.n_vars, dtype, ac) for g in mop.groups)
        #: whether a group draws random numbers (``RbfConfig.use_max_points``)
        self.draws = any(isinstance(g.cfg, RbfConfig) and g.cfg.use_max_points
                         for g in mop.groups)
        # index of the earlier RBF group with the same geometry signature
        # whose rounds-1-3 set each group reuses, or None
        self.reuse_from = []
        for i, g in enumerate(mop.groups):
            src = None
            if isinstance(g.cfg, RbfConfig):
                for j in range(i):
                    cj = mop.groups[j].cfg
                    if isinstance(cj, RbfConfig) and cj.signature() == g.cfg.signature():
                        src = j
                        break
            self.reuse_from.append(src)
        #: the solver's live log (``utils/logging.LiveLog``), or None
        self.log = None

    # ------------------------------------------------------------- state init
    def init_group_states(self, B: int):
        return tuple(
            GroupState(db=dbm.init_database(B, self.db_capacity,
                                            self.mop.n_vars, g.m, self.dtype,
                                            self.device),
                       model=ops.init_state(B, self.device),
                       n_evals=torch.zeros((B,), dtype=torch.int32,
                                           device=self.device))
            for g, ops in zip(self.mop.groups, self.ops))

    # --------------------------------------------------------- true evaluation
    def evaluate_true(self, states, x_s, scal, active=None):
        """Evaluate every group's true functions at one scaled site per
        lane, insert the results and bump the counters
        (``algorithm.jl:760-764``). Returns (fx, c_e, c_i, states,
        x_indices (B, G)). ``active`` (B,): the lanes whose results the
        caller keeps; a host group is called at those lanes only (zeros
        elsewhere)."""
        x = scaling.untransform(scal, x_s)
        vals, new_states, x_indices = [], [], []
        for g, st in zip(self.mop.groups, states):
            v = (g.eval_unscaled_batch_masked(x, active) if g.any_host
                 else g.eval_unscaled(x))
            db, idx = dbm.add_evaluated(st.db, x_s, v)
            vals.append(v)
            x_indices.append(idx)
            new_states.append(st._replace(db=db, n_evals=st.n_evals + 1))
        return (*self.mop.scatter_role_vectors(vals, x), tuple(new_states),
                torch.stack(x_indices, dim=-1))

    def ensure_evaluated(self, states, x_s, scal):
        """Like :meth:`evaluate_true`, but reuse an evaluated database row
        holding the same site (``ensure_contains_values!``,
        ``algorithm.jl:289-295``); a host group is called at the lanes
        without one only."""
        x = scaling.untransform(scal, x_s)
        vals, new_states, x_indices = [], [], []
        for g, st in zip(self.mop.groups, states):
            db = st.db
            hits = ((db.X == x_s[:, None, :]).all(-1) & dbm.valid_mask(db)
                    & db.evaluated)
            found = hits.any(-1)
            found_id = torch.argmax(hits.to(torch.int32), dim=-1).to(torch.int32)
            v_new = (g.eval_unscaled_batch_masked(x, ~found) if g.any_host
                     else g.eval_unscaled(x))
            v_old = torch.gather(db.Y, 1, found_id.long()[:, None, None]
                                 .expand(-1, 1, g.m))[:, 0]
            v = torch.where(found[:, None], v_old, v_new)
            db, add_id = dbm.add_evaluated(db, x_s, v, do_add=~found)
            idx = torch.where(found, found_id, add_id)
            vals.append(v)
            x_indices.append(idx)
            new_states.append(st._replace(
                db=db, n_evals=st.n_evals + (~found).to(torch.int32)))
        return (*self.mop.scatter_role_vectors(vals, x), tuple(new_states),
                torch.stack(x_indices, dim=-1))

    # ------------------------------------------------------------ model update
    def _contexts(self, states, x_s, x_indices, delta, scal, active=None, key=None):
        """One context per group. When a group draws, ``key`` (B, 2) is
        split into one key per group (``PRNGKey(0)`` without one), as the
        JAX package splits it (container.py:146-156)."""
        keys = [None] * len(states)
        if self.draws:
            if key is None:
                key = prng.prng_key(0, x_s.device).expand(x_s.shape[0], 2)
            keys = prng.split(key, len(states)).unbind(1)
        return [ModelContext(x_s=x_s, x_index=x_indices[:, i], delta=delta,
                             n_evals=st.n_evals, scal=scal, active=active, key=keys[i])
                for i, st in enumerate(states)]

    def update(self, states, x_s, x_indices, delta, ensure_fully_linear,
               scal):
        """``update_surrogates!`` (``SurrogateContainer.jl:334-391``):
        prepare all groups, batch-evaluate missing sites, fit."""
        ctxs = self._contexts(states, x_s, x_indices, delta, scal)
        mid = []
        for gi, (ops, st, ctx) in enumerate(zip(self.ops, states, ctxs)):
            model, db = self._prepare(gi, st, ctx, ensure_fully_linear, mid)
            mid.append(st._replace(model=model, db=db))
        return self._finish_two_phase(mid, ctxs, None)

    def _prepare(self, gi, st, ctx, ensure_fully_linear, mid):
        """The update-path phase 1 of group ``gi``; ``mid`` holds the
        phase-1 results of the groups before it (the reuse source)."""
        src = self.reuse_from[gi]
        if src is not None:
            return self.ops[gi].prepare_with_reuse(st.model, st.db, ctx,
                                                   mid[src].model, mid[src].db)
        return self.ops[gi].prepare(st.model, st.db, ctx, ensure_fully_linear)

    def update_or_improve(self, states, x_s, x_indices, delta, improve_flag,
                          scal, efl_flag, active=None, key=None, log_when=None):
        """Update or improve, selected per lane by ``improve_flag``
        (``algorithm.jl:682-688``): both phase-1 variants run and are
        selected (in one pass where the family offers
        ``prepare_or_improve``), then evaluation and fitting run once.
        ``efl_flag`` is the per-lane ensure-fully-linear flag of criticality
        rebuild passes; ``active`` marks the lanes whose update the caller
        keeps; ``key`` (B, 2) the pass's PRNG key where a group draws;
        ``log_when`` (B,) the lanes whose update the live log reports."""
        ctxs = self._contexts(states, x_s, x_indices, delta, scal, active, key)
        mid = []
        for gi, (ops, st, ctx) in enumerate(zip(self.ops, states, ctxs)):
            if hasattr(ops, "prepare_or_improve"):
                model, db = ops.prepare_or_improve(st.model, st.db, ctx, improve_flag,
                                                   efl_flag)
                mid.append(st._replace(model=model, db=db))
                continue
            imp = ops.prepare_improve(st.model, st.db, ctx)
            upd = self._prepare(gi, st, ctx, efl_flag, mid)
            model, db = tree_where(improve_flag, imp, upd)
            mid.append(st._replace(model=model, db=db))
        return self._finish_two_phase(mid, ctxs, log_when)

    def _finish_two_phase(self, mid, ctxs, log_when):
        scal, keep = ctxs[0].scal, ctxs[0].active
        out = []
        for gi, (g, ops, st, ctx) in enumerate(zip(self.mop.groups, self.ops, mid, ctxs)):
            unscaled = lambda X: scaling.untransform(broadcast_scaler(scal, X), X)
            fn = lambda X, g=g: g.eval_unscaled(unscaled(X))
            # a host group: the missing rows of the lanes the caller keeps
            batch_fn = None
            if g.any_host:
                batch_fn = lambda X, missing, g=g: g.eval_unscaled_batch_masked(
                    unscaled(X), missing if keep is None else missing & keep[:, None])
            # tail window only for large databases (``eval_missing``)
            win = ops.eval_window if (self.db_capacity >= 256 and
                                      self.db_capacity >= 8 * ops.eval_window) else None
            db, n_new = dbm.eval_missing(st.db, fn, window=win, eval_batch_masked=batch_fn)
            st = st._replace(db=db, n_evals=st.n_evals + n_new)
            model = ops.fit(st.model, st.db, ctx)
            if self.log is not None:
                # model-build internals (JAX container.py:244-252)
                self.log.add(5, "|   (Models) group {g}: n_train={n} fully_linear={f} "
                             "db_count={c} delta={d:.3e}", log_when, g=gi,
                             n=getattr(model, "n_train", -1), f=ops.fully_linear(model),
                             c=st.db.count, d=ctx.delta)
            out.append(st._replace(model=model))
        return tuple(out)

    # ------------------------------------------------------------- model evals
    def _gather(self, states, x_s, which, role, scal, counted=True):
        """Evaluate (``which='eval'``) or differentiate (``'jac'``) the
        models of the groups serving ``role``, directly or through a
        composite, and scatter them into the role vector; a counted
        evaluation bumps those groups' counters where the model is the true
        function. Returns (values, states)."""
        comps = [cs for cs in self.mop.composites if cs.role == role]
        comp_groups = {cs.group_index for cs in comps}
        out, vals, new_states = [], {}, list(states)
        for i, (g, ops, st) in enumerate(zip(self.mop.groups, self.ops, states)):
            if not any(mb.role == role for mb in g.members) and i not in comp_groups:
                out.append(None)
                continue
            if which == "eval" or i in comp_groups:
                vals[i] = ops.eval(st.model, x_s, scal)
            if which == "eval":
                if ops.counts_on_eval and counted:
                    new_states[i] = st._replace(n_evals=st.n_evals + 1)
                out.append(vals[i])
            else:
                out.append(ops.jac(st.model, x_s, scal))
        comp_out = None
        if comps:
            sc = broadcast_scaler(scal, x_s)
            x = scaling.untransform(sc, x_s)
            comp_out = []
            for cs in self.mop.composites:
                if cs.role != role:
                    comp_out.append(None)
                    continue
                inner = cs.inner(vals[cs.group_index])
                if which == "eval":
                    comp_out.append(cs.eval(x, inner))
                    continue
                # the chain rule of ``CompositeSurrogate``
                # (``AbstractSurrogateInterface.jl:193-229``)
                d_x, d_g = cs.partials(x, inner)
                J_m = out[cs.group_index][..., cs.group_offset:cs.group_offset + cs.width, :]
                comp_out.append(chain_rule(d_x / sc.scale[..., None, :], d_g, J_m))
        if all(v is None for v in out) and comp_out is None:
            B, n = x_s.shape[0], self.mop.n_vars
            shape = (B, 0) if which == "eval" else (B, 0, n)
            return x_s.new_zeros(shape), tuple(new_states)
        axis = -1 if which == "eval" else -2
        return (self.mop.scatter_role(out, role, axis, composite_values=comp_out),
                tuple(new_states))

    def eval_objectives(self, states, x_s, scal):
        """Model objective values at one site per lane, counted
        (``SurrogateContainer.jl:234-269``). Returns (values, states)."""
        return self._gather(states, x_s, "eval", OBJECTIVE, scal)

    def eval_objectives_raw(self, states, x_s, scal):
        """Model objective values at sites ``x_s (B, ..., n)``, uncounted
        (the sweeps of the Pascoletti-Serafini subsolvers, whose evaluations
        :meth:`charge_evals` charges by their budgets)."""
        return self._gather(states, x_s, "eval", OBJECTIVE, scal, counted=False)[0]

    def eval_objectives_batch(self, states, X, scal):
        """(B, K, m_obj) model objective values at K sites per lane,
        uncounted."""
        return self.eval_objectives_raw(states, X, scal)

    def charge_evals(self, states, k, objectives_only: bool = False):
        """Add ``k`` (per lane) true-function evals to exact groups: what
        the reference's sequential loops would have evaluated. With
        ``objectives_only`` a group serving no objective is not charged
        (``descent.jl:150-185``)."""
        out = []
        for g, ops, st in zip(self.mop.groups, self.ops, states):
            if ops.counts_on_eval and (g.has_objective or not objectives_only):
                st = st._replace(n_evals=st.n_evals + k.to(torch.int32))
            out.append(st)
        return tuple(out)

    def jac_objectives(self, states, x_s, scal):
        """(B, m_obj, n) model objective Jacobians at one site per lane."""
        return self._gather(states, x_s, "jac", OBJECTIVE, scal)[0]

    def eval_nl_eq(self, states, x_s, scal):
        return self._gather(states, x_s, "eval", NL_EQ, scal)

    def eval_nl_ineq(self, states, x_s, scal):
        return self._gather(states, x_s, "eval", NL_INEQ, scal)

    def eval_nl_eq_raw(self, states, x_s, scal):
        return self._gather(states, x_s, "eval", NL_EQ, scal, counted=False)[0]

    def eval_nl_ineq_raw(self, states, x_s, scal):
        return self._gather(states, x_s, "eval", NL_INEQ, scal, counted=False)[0]

    def jac_nl_eq(self, states, x_s, scal):
        """(B, m_ce, n) model Jacobians of the equality constraints."""
        return self._gather(states, x_s, "jac", NL_EQ, scal)[0]

    def jac_nl_ineq(self, states, x_s, scal):
        """(B, m_ci, n) model Jacobians of the inequality constraints."""
        return self._gather(states, x_s, "jac", NL_INEQ, scal)[0]

    def jac_all(self, states, x_s, scal):
        """(B, m_obj + m_ce + m_ci, n) model Jacobians of every function,
        objectives then nonlinear constraints: the input of the ``'model'``
        scaler update (``new_var_scaler``, ``VarScaler.jl:240-260``)."""
        parts = [self.jac_objectives(states, x_s, scal)]
        if self.mop.m_ce > 0:
            parts.append(self.jac_nl_eq(states, x_s, scal))
        if self.mop.m_ci > 0:
            parts.append(self.jac_nl_ineq(states, x_s, scal))
        return torch.cat(parts, dim=-2)

    # ------------------------------------------------- model-meta provenance
    @property
    def train_stamp_len(self) -> int:
        return sum(ops.train_stamp_len for ops in self.ops)

    def train_stamps(self, states):
        """(B, train_stamp_len) per-group training-set provenance, int32 —
        the model part of the reference's per-iteration ``IterSaveable``
        (``IterDataIterSaveable.jl:189-216``)."""
        parts = [ops.train_stamp(st.model)
                 for ops, st in zip(self.ops, states) if ops.train_stamp_len]
        B = states[0].n_evals.shape[0]
        if not parts:
            return torch.zeros((B, 0), dtype=torch.int32, device=self.device)
        return torch.cat(parts, dim=-1)

    # ------------------------------------------------------------------- flags
    def fully_linear(self, states):
        """AND over groups, per lane."""
        B = states[0].n_evals.shape[0]
        flag = torch.ones((B,), dtype=torch.bool, device=self.device)
        for ops, st in zip(self.ops, states):
            flag = flag & ops.fully_linear(st.model)
        return flag

    def set_fully_linear(self, states, val):
        """Set every group's fully-linear flag (where the family keeps one)
        to ``val``, a bool or a (B,) mask."""
        return tuple(st._replace(model=ops.set_fully_linear(st.model, val))
                     for ops, st in zip(self.ops, states))

    # ------------------------------------------------------------------ budget
    def budget_exhausted(self, states):
        """``_budget_okay`` negation (``algorithm.jl:6-12``): any objective
        group at or above its eval cap."""
        B = states[0].n_evals.shape[0]
        flag = torch.zeros((B,), dtype=torch.bool, device=self.device)
        for g, st in zip(self.mop.groups, states):
            cap = min(self.ac.max_evals, g.max_evals)
            if not g.has_objective or cap >= 2 ** 31 - 1:
                continue
            flag = flag | (st.n_evals >= cap)
        return flag
