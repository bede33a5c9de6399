"""Multiobjective problem definition and compilation.

Counterpart of ``morbit_tpu/core/mop.py`` (reference ``src/MOP.jl:9-107``).
User functions are plain torch functions of ONE unscaled site ``x (n,) ->
(n_out,)`` (or a scalar); the package batches them with
``torch.func.vmap``. Jacobians come from the user's ``jac`` callback, else
``torch.func.jacrev``.

This package solves unconstrained and box-constrained problems with exact
and RBF objectives; constraints, composites and the other surrogate models
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import jacrev, vmap

from morbit_tpu_torch.models.configs import (ExactConfig, RbfConfig,
                                             SurrogateConfig, check_ported)

OBJECTIVE = "objective"

_CONSTRAINTS_LATER = ("constraints are not ported to morbit_tpu_torch yet: "
                      "they arrive with the constraints slice (filter, "
                      "normal step, restoration)")


def _flat_map(fn, X, out_shape):
    """Apply a single-site function over all leading axes of ``X``."""
    lead = X.shape[:-1]
    flat = X.reshape((-1, X.shape[-1]))
    out = vmap(fn)(flat)
    return out.reshape(lead + out_shape)


@dataclasses.dataclass(frozen=True, eq=False)
class VecFun:
    """A (vector-valued) user function with its model config and optional
    Jacobian callback (``src/VecFun.jl:13-98``)."""

    fn: Callable
    n_out: int
    model_cfg: SurrogateConfig
    role: str
    jac: Optional[Callable] = None     # x -> (n_out, n) Jacobian callback
    max_evals: int = 2 ** 31 - 1

    def _fn_vec(self, x):
        return self.fn(x).reshape((self.n_out,))

    def eval(self, X: torch.Tensor) -> torch.Tensor:
        """Values at sites ``X (..., n)`` -> ``(..., n_out)``."""
        return _flat_map(self._fn_vec, X, (self.n_out,))

    def jacobian(self, X: torch.Tensor) -> torch.Tensor:
        """Jacobians at sites ``X (..., n)`` -> ``(..., n_out, n)``: the user
        callback, else reverse-mode autodiff (``DiffFn.jl:56-148``)."""
        n = X.shape[-1]
        jac = self.jac if self.jac is not None else jacrev(self._fn_vec)
        return _flat_map(lambda x: jac(x).reshape((self.n_out, n)), X,
                         (self.n_out, n))


class MOP:
    """Mutable problem container (``src/MOP.jl:9-25``).

    ``MOP(n)`` — n unconstrained variables; ``MOP(lb, ub)`` — box
    constrained."""

    def __init__(self, n_or_lb, ub=None):
        if ub is None and np.isscalar(n_or_lb):
            self.n_vars = int(n_or_lb)
            self.lb = np.full(self.n_vars, -np.inf)
            self.ub = np.full(self.n_vars, np.inf)
        else:
            self.lb = np.asarray(n_or_lb, float)
            self.ub = np.asarray(ub, float)
            if self.lb.shape != self.ub.shape:
                raise ValueError("lb and ub must have the same shape")
            self.n_vars = self.lb.shape[0]
        self.functions: list[VecFun] = []

    def add_objective(self, fn, n_out=1, model_cfg=None, jac=None,
                      max_evals=2 ** 31 - 1):
        """Add an objective; like the JAX package the default model is an
        RBF surrogate (``RbfConfig()``)."""
        cfg = check_ported(RbfConfig() if model_cfg is None else model_cfg)
        self.functions.append(VecFun(fn=fn, n_out=int(n_out), model_cfg=cfg,
                                     role=OBJECTIVE, jac=jac,
                                     max_evals=max_evals))
        return len(self.functions) - 1

    def add_exact_objective(self, fn, n_out=1, jac=None, max_evals=2 ** 31 - 1):
        """``add_exact_objective!`` — Jacobians from ``jac`` or autodiff."""
        return self.add_objective(fn, n_out, ExactConfig(), jac, max_evals)

    def add_eq_constraint(self, A, b):
        raise NotImplementedError(_CONSTRAINTS_LATER)

    def add_ineq_constraint(self, A, b):
        raise NotImplementedError(_CONSTRAINTS_LATER)

    def add_nl_eq_constraint(self, fn, n_out=1, **kw):
        raise NotImplementedError(_CONSTRAINTS_LATER)

    def add_nl_ineq_constraint(self, fn, n_out=1, **kw):
        raise NotImplementedError(_CONSTRAINTS_LATER)

    @property
    def num_objectives(self):
        return sum(f.n_out for f in self.functions if f.role == OBJECTIVE)


@dataclasses.dataclass(frozen=True, eq=False)
class GroupMember:
    fn_index: int        # index into mop.functions
    group_offset: int    # offset of this function's outputs inside the group
    global_offset: int   # offset inside the objective vector
    n_out: int
    role: str


@dataclasses.dataclass(frozen=True, eq=False)
class GroupSpec:
    """One surrogate group (``SurrogateContainer.jl:48-99``)."""

    index: int
    cfg: SurrogateConfig
    fns: tuple           # tuple[VecFun]
    members: tuple       # tuple[GroupMember]
    m: int               # total outputs
    max_evals: int       # min over member functions and cfg
    has_objective: bool

    def eval_unscaled(self, X: torch.Tensor) -> torch.Tensor:
        """Concatenated member values at unscaled sites ``(..., n)``."""
        return torch.cat([f.eval(X) for f in self.fns], dim=-1)

    def jac_unscaled(self, X: torch.Tensor) -> torch.Tensor:
        return torch.cat([f.jacobian(X) for f in self.fns], dim=-2)


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledMOP:
    """Frozen problem (``MOPTyped`` analogue, ``src/MOP.jl:27-82``)."""

    n_vars: int
    lb: np.ndarray
    ub: np.ndarray
    groups: tuple        # tuple[GroupSpec]
    m_obj: int

    def scatter_objectives(self, group_values) -> torch.Tensor:
        """Per-group output vectors ``(..., m_g)`` -> objective vector
        ``(..., m_obj)``."""
        parts = [None] * self.m_obj
        for g, vals in zip(self.groups, group_values):
            for mb in g.members:
                for k in range(mb.n_out):
                    parts[mb.global_offset + k] = vals[..., mb.group_offset + k]
        return torch.stack(parts, dim=-1)


def compile_mop(mop: MOP, combine_models: bool = True) -> CompiledMOP:
    """Freeze the problem: groups and output maps (``do_groupings``,
    ``SurrogateContainer.jl:2-46``). The same callable registered twice is
    ONE function evaluated once per site (``RefVecFun`` sharing)."""
    if mop.num_objectives == 0:
        raise ValueError("`mop` has no objectives!")
    canonical: dict[int, int] = {}
    for i, f in enumerate(mop.functions):
        canonical[i] = i
        for j in range(i):
            g = mop.functions[j]
            if (f.fn is g.fn and f.n_out == g.n_out and f.jac is g.jac
                    and f.model_cfg == g.model_cfg):
                canonical[i] = canonical[j]
                break

    group_lists: list[list[int]] = []
    group_cfgs: list = []
    for i, f in enumerate(mop.functions):
        if canonical[i] != i:
            continue
        placed = False
        if combine_models and f.model_cfg.combinable:
            for gi, cfg in enumerate(group_cfgs):
                if cfg == f.model_cfg and type(cfg) is type(f.model_cfg):
                    group_lists[gi].append(i)
                    placed = True
                    break
        if not placed:
            group_lists.append([i])
            group_cfgs.append(f.model_cfg)

    offsets, off = {}, 0
    for i, f in enumerate(mop.functions):
        offsets[i] = off
        off += f.n_out

    groups, location = [], {}
    for gi, fn_ids in enumerate(group_lists):
        members, fns, goff, max_ev = [], [], 0, 2 ** 31 - 1
        for i in fn_ids:
            f = mop.functions[i]
            members.append(GroupMember(i, goff, offsets[i], f.n_out, f.role))
            location[i] = (gi, goff)
            goff += f.n_out
            fns.append(f)
            max_ev = min(max_ev, f.max_evals, f.model_cfg.max_evals)
        groups.append(GroupSpec(index=gi, cfg=group_cfgs[gi], fns=tuple(fns),
                                members=tuple(members), m=goff,
                                max_evals=max_ev, has_objective=True))
    for i, can in canonical.items():
        if can == i:
            continue
        f = mop.functions[i]
        gi, goff = location[can]
        g = groups[gi]
        groups[gi] = dataclasses.replace(
            g, members=g.members + (GroupMember(i, goff, offsets[i], f.n_out,
                                                f.role),),
            max_evals=min(g.max_evals, f.max_evals, f.model_cfg.max_evals))

    return CompiledMOP(n_vars=mop.n_vars, lb=mop.lb, ub=mop.ub,
                       groups=tuple(groups), m_obj=off)
