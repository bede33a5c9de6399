"""Problems whose functions depend on per-lane data θ.

Counterpart of the ``mop_builder`` path of the JAX package's
``parametric_multistart`` (``morbit_tpu/parallel/multistart.py:862-909``),
where ``jax.vmap`` traces the builder once with θ as a tracer, so that one
program solves a different problem instance per lane.

Here the builder is called on the first lane's θ to compile the problem
once, for its static structure. Each of its functions then evaluates a
batch of sites ``X (B, ..., n)`` as one ``torch.func.vmap`` over the lane
axis of ``(X, θ)``: inside it, the builder is called on the lane's θ and
the lane's own function maps over the lane's sites. That is one Python
call of the builder per evaluation, whatever B. Jacobians (``jacrev``),
Hessians and composite outer functions go the same way.

The solver binds the lanes' θ (a tuple of ``(B, ...)`` tensors, a leaf of
``SolverState``) before every trip (:meth:`LaneData.bind`), so compaction,
the mesh's shards, carried states and checkpoints move θ with its lane.
Every evaluation checks that the leading axis of its sites is the lane
axis of the bound θ.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import vmap

from morbit_tpu_torch.core.mop import CompiledMOP, CompositeSpec, VecFun, compile_mop


# ------------------------------------------------------------- θ as leaves

def flatten(tree):
    """``(leaves, rebuild)`` of a tree of dicts (sorted keys, as JAX orders
    them), lists, tuples and NamedTuples over array leaves;
    ``rebuild(leaves)`` gives the tree back with new leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
        sizes = [len(p[0]) for p in parts]

        def rebuild(leaves):
            out, i = {}, 0
            for k, (_, sub), s in zip(keys, parts, sizes):
                out[k] = sub(leaves[i:i + s])
                i += s
            return out
        return [leaf for p in parts for leaf in p[0]], rebuild
    if isinstance(tree, (list, tuple)):
        parts = [flatten(v) for v in tree]
        sizes = [len(p[0]) for p in parts]

        def rebuild(leaves):
            out, i = [], 0
            for (_, sub), s in zip(parts, sizes):
                out.append(sub(leaves[i:i + s]))
                i += s
            if hasattr(tree, "_fields"):
                return type(tree)(*out)
            return type(tree)(out)
        return [leaf for p in parts for leaf in p[0]], rebuild
    return [tree], lambda leaves: leaves[0]


def cast_leaf(a, dtype, device) -> torch.Tensor:
    """A θ leaf on ``device``: float leaves in the solve dtype, integer and
    boolean leaves in their own (JAX's ``cast``, multistart.py:894-897)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)


# --------------------------------------------------------- per-lane data

class LaneData:
    """The builder, the rebuild of θ from its leaves, and the θ leaves bound
    for the current trip (per thread: the mesh's shards run in threads)."""

    def __init__(self, builder: Callable, rebuild: Callable, combine_models: bool):
        self.builder = builder
        self.rebuild = rebuild
        self.combine_models = combine_models
        self._local = threading.local()

    def bind(self, theta: tuple) -> None:
        self._local.theta = tuple(theta)

    def compiled(self, leaves) -> CompiledMOP:
        mop = self.builder(self.rebuild(list(leaves)))
        return mop if isinstance(mop, CompiledMOP) else compile_mop(mop, self.combine_models)

    def lanes(self, X: torch.Tensor, what: str) -> tuple:
        """The bound θ leaves, after checking that ``X``'s leading axis is
        their lane axis."""
        theta = getattr(self._local, "theta", None)
        if not theta:
            raise RuntimeError(f"{what} of a parametric problem with no θ bound; "
                               "solve it with parametric_multistart")
        B = theta[0].shape[0]
        if X.dim() < 2 or X.shape[0] != B:
            raise RuntimeError(
                f"{what} of a parametric problem at sites of shape {tuple(X.shape)}: "
                f"the leading axis must be the lane axis ({B} lanes)")
        return theta


@dataclasses.dataclass(frozen=True, eq=False)
class LaneVecFun(VecFun):
    """A function of a parametric problem: each lane's sites go through the
    function the builder gives for that lane's θ (``group``, ``slot``: its
    place in the compiled problem)."""

    lane_data: Optional[LaneData] = None
    group: int = 0
    slot: int = 0

    def _per_lane(self, X, method: str):
        theta = self.lane_data.lanes(X, method)

        def one(Xl, *leaves):
            f = self.lane_data.compiled(leaves).groups[self.group].fns[self.slot]
            return getattr(f, method)(Xl)
        return vmap(one)(X, *theta)

    def eval(self, X):
        return self._per_lane(X, "eval")

    def jacobian(self, X, mask=None):
        return self._per_lane(X, "jacobian")

    def hessians(self, X):
        return self._per_lane(X, "hessians")


@dataclasses.dataclass(frozen=True, eq=False)
class LaneCompositeSpec(CompositeSpec):
    """A composite of a parametric problem, its outer function per lane."""

    lane_data: Optional[LaneData] = None
    slot: int = 0

    def _per_lane(self, X, G, method: str):
        theta = self.lane_data.lanes(X, method)

        def one(Xl, Gl, *leaves):
            return getattr(self.lane_data.compiled(leaves).composites[self.slot],
                           method)(Xl, Gl)
        return vmap(one)(X, G, *theta)

    def eval(self, X, G):
        return self._per_lane(X, G, "eval")

    def partials(self, X, G):
        return self._per_lane(X, G, "partials")


# ------------------------------------------------------ the static structure

def _structure(cm: CompiledMOP) -> dict:
    """What must not depend on θ, field by field."""
    return {
        "n_vars": cm.n_vars,
        "lb": cm.lb.tolist(), "ub": cm.ub.tolist(),
        "A_eq": cm.A_eq.tolist(), "b_eq": cm.b_eq.tolist(),
        "A_ineq": cm.A_ineq.tolist(), "b_ineq": cm.b_ineq.tolist(),
        "output widths": (cm.m_obj, cm.m_ce, cm.m_ci),
        "groups": [[(mb.fn_index, mb.group_offset, mb.global_offset, mb.n_out, mb.role)
                    for mb in g.members] for g in cm.groups],
        "configs": [(g.cfg, g.max_evals) for g in cm.groups],
        "functions": [[(f.n_out, f.role, f.host, f.can_batch, f.max_evals)
                       for f in g.fns] for g in cm.groups],
        "composites": [(c.role, c.global_offset, c.n_out, c.group_index, c.group_offset,
                        c.width) for c in cm.composites],
    }


def parametric_mop(builder: Callable, theta: tuple, rebuild: Callable,
                   combine_models: bool) -> CompiledMOP:
    """The compiled problem of ``builder`` whose functions evaluate per lane
    (``theta``: the leaves, lane axis first). The builds for the first and
    the last lane must agree on the static structure (a ``ValueError``
    names the first field that differs), and no function may be a host
    function."""
    lane_data = LaneData(builder, rebuild, combine_models)
    first = lane_data.compiled([t[0] for t in theta])
    last = lane_data.compiled([t[-1] for t in theta])
    a, b = _structure(first), _structure(last)
    for field in a:
        if a[field] != b[field]:
            raise ValueError(
                f"parametric_multistart: the problem's {field} depends on theta "
                f"(lane 0: {a[field]}, lane {theta[0].shape[0] - 1}: {b[field]}); "
                "only the values of the functions may")
    if any(f.host for g in first.groups for f in g.fns):
        raise ValueError(
            "parametric_multistart: host (NumPy) functions cannot take a per-lane "
            "theta (the JAX package's pure_callback has no defined behaviour for a "
            "closure over the traced theta); write the function in torch")
    groups = tuple(dataclasses.replace(g, fns=tuple(
        LaneVecFun(**{f.name: getattr(fn, f.name) for f in dataclasses.fields(VecFun)},
                   lane_data=lane_data, group=gi, slot=j)
        for j, fn in enumerate(g.fns))) for gi, g in enumerate(first.groups))
    composites = tuple(
        LaneCompositeSpec(**{f.name: getattr(c, f.name)
                             for f in dataclasses.fields(CompositeSpec)},
                          lane_data=lane_data, slot=ci)
        for ci, c in enumerate(first.composites))
    return dataclasses.replace(first, groups=groups, composites=composites,
                               lanes=lane_data)
