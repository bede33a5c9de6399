"""Surrogate model interface (functional, static-shape, batched).

Counterpart of ``morbit_tpu/models/base.py``: the reference's 2-phase
surrogate protocol (``AbstractSurrogateInterface.jl:25-79``) as pure
functions per model family on batched state::

    prepare(state, db, ctx, ensure_fully_linear) -> (state, db)  # enqueue sites
    fit(state, db, ctx)                          -> state        # fit from db
    prepare_improve(state, db, ctx)              -> (state, db)
    eval(state, x_s, scal)                       -> (B, ..., m)
    jac(state, x_s, scal)                        -> (B, m, n)
    fully_linear(state)                          -> (B,) bool, or a bool
                                                    for every lane
    set_fully_linear(state, val)                 -> state
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ModelContext(NamedTuple):
    """Per-iteration inputs to the model build, one row per lane."""

    x_s: torch.Tensor      # (B, n) current iterate, scaled
    x_index: torch.Tensor  # (B,) int32 row of the iterate in this group's db
    delta: torch.Tensor    # (B,) trust-region radius
    n_evals: torch.Tensor  # (B,) int32 group eval counter
    scal: object           # VarScaler with (B, n) fields
    # (B,) bool: the lanes whose result the caller keeps (None: all). A
    # family may skip work that no kept lane needs; every lane's values
    # stay what they would be without it.
    active: Optional[torch.Tensor] = None
    # (B, 2) per-lane PRNG key of this group's pass (``ops/prng.py``; the
    # round-4 random candidates of ``RbfConfig(use_max_points=True)``),
    # None when no group draws
    key: Optional[torch.Tensor] = None


class SurrogateOps:
    """Base class; subclasses implement the protocol above."""

    #: True if evaluating the *model* consumes true-function budget (only
    #: the exact model, ``src/models/ExactModel.jl:22-119``)
    counts_on_eval: bool = False

    #: static bound on new (unevaluated) sites one prepare/improve call can
    #: add — lets eval_missing evaluate only a tail window of the database
    eval_window: int = 1

    #: static length of :meth:`train_stamp` (0: the family keeps no
    #: training-set provenance; RBF overrides)
    train_stamp_len: int = 0

    def __init__(self, group, n_vars: int, dtype, ac):
        self.group = group
        self.cfg = group.cfg
        self.n_vars = n_vars
        self.dtype = dtype
        self.ac = ac

    def init_state(self, B: int, device):
        raise NotImplementedError

    def prepare(self, state, db, ctx: ModelContext, ensure_fully_linear):
        return state, db

    def fit(self, state, db, ctx: ModelContext):
        return state

    def prepare_improve(self, state, db, ctx: ModelContext):
        return state, db

    def eval(self, state, x_s, scal):
        raise NotImplementedError

    def jac(self, state, x_s, scal):
        raise NotImplementedError

    def fully_linear(self, state):
        raise NotImplementedError

    def set_fully_linear(self, state, val):
        """Families without a fully-linear flag (exact) keep their state."""
        return state

    def train_stamp(self, state):
        """Per-iteration training-set provenance, (B, train_stamp_len) int32:
        ``[n_train, db row indices...]`` for families that keep one
        (``RbfModel.jl:162-175``, ``IterDataIterSaveable.jl:189-216``)."""
        raise NotImplementedError
