"""Multiobjective problem definition and compilation.

Counterpart of ``morbit_tpu/core/mop.py`` (reference ``src/MOP.jl:9-107``).
User functions are plain torch functions of ONE unscaled site ``x (n,) ->
(n_out,)`` (or a scalar); the package batches them with
``torch.func.vmap``. Jacobians come from the user's ``jac`` callback, else
``torch.func.jacrev``; Hessians (Taylor models in callback mode) from the
``hess`` callback, else ``torch.func.jacfwd(jacrev)``.

Objectives and nonlinear constraints of every model family, box
constraints, linear equality and inequality rows and composite functions
``phi(x, g(x))`` (a cheap known outer ``phi`` over a modelled inner ``g``
registered with :meth:`MOP.add_function`) are ported. Outer functions are
plain torch functions of one unscaled site and the inner values, batched
with ``torch.func.vmap`` and differentiated with ``torch.func.jacfwd``.

``host=True`` registers a black box: a plain Python/NumPy callable that
runs on the host (the JAX package bridges it with ``jax.pure_callback``).
It gets NumPy arrays in the solver's dtype: one site ``(n,)`` a call, or
with ``can_batch`` a whole ``(K, n)`` batch whose ``(K, n_out)`` values it
returns. A pass over host functions copies the sites to the host in one
transfer and the values back in another (:func:`host_pass`); with a mask
only the masked rows reach the user's code, so it runs only at sites the
solver keeps and counts. Jacobians and Hessians of host functions without
callbacks are central finite differences (``fd_step``), as in the JAX
package. Each host function keeps its own tallies in ``VecFun.stats``
(:class:`HostStats`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import jacfwd, jacrev, vmap

from morbit_tpu_torch.models.configs import (ExactConfig, LagrangeConfig,
                                             RbfConfig, SurrogateConfig,
                                             TaylorConfig, check_ported)

OBJECTIVE = "objective"
NL_EQ = "nl_eq"
NL_INEQ = "nl_ineq"
INNER = "inner"  # modelled function used only inside composites


def _flat_map(fn, X, out_shape, G=None):
    """Apply a single-site function over all leading axes of ``X`` (and of
    ``G``, the inner values of a composite, which share them)."""
    lead = X.shape[:-1]
    flat = X.reshape((-1, X.shape[-1]))
    if G is None:
        out = vmap(fn)(flat)
    else:
        out = vmap(fn)(flat, G.reshape((-1, G.shape[-1])))
    if isinstance(out, tuple):
        return tuple(o.reshape(lead + o.shape[1:]) for o in out)
    return out.reshape(lead + out_shape)


#: the kinds of rows a host function is called at: counted true
#: evaluations, finite-difference stencils of Jacobians and Hessians, and
#: the restoration loop's merit passes (the last two uncounted, as in the
#: JAX package)
HOST_KINDS = ("eval", "fd", "restoration")


@dataclasses.dataclass
class HostStats:
    """Tallies of one host function since :meth:`reset`: its rows by kind
    (``rows[kind]``), its calls (one a batch with ``can_batch``, else one a
    row), the host passes that reached it (``round_trips``: one copy of the
    sites to the host and one of the values back), the seconds spent inside
    it, and the ``"eval"`` rows of each lane (``lane_rows``, while every
    pass has the same lane count; else None)."""

    rows: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(HOST_KINDS, 0))
    calls: int = 0
    round_trips: int = 0
    seconds: float = 0.0
    lane_rows: Optional[np.ndarray] = None
    _lanes_valid: bool = True

    def reset(self):
        self.__init__()

    def add_lanes(self, per_lane: np.ndarray):
        if not self._lanes_valid:
            return
        if self.lane_rows is None:
            self.lane_rows = np.zeros(per_lane.shape, np.int64)
        if self.lane_rows.shape != per_lane.shape:
            self.lane_rows, self._lanes_valid = None, False
            return
        self.lane_rows += per_lane


@dataclasses.dataclass(frozen=True, eq=False)
class VecFun:
    """A (vector-valued) user function with its model config and optional
    Jacobian callback (``src/VecFun.jl:13-98``). ``host``, ``can_batch``
    and ``fd_step`` as in the JAX package (see the module docstring)."""

    fn: Callable
    n_out: int
    model_cfg: SurrogateConfig
    role: str
    jac: Optional[Callable] = None     # x -> (n_out, n) Jacobian callback
    hess: Optional[Callable] = None    # x -> (n_out, n, n) Hessians callback
    max_evals: int = 2 ** 31 - 1
    host: bool = False
    can_batch: bool = False
    fd_step: float = 1.49e-7           # ~10 sqrt(eps64), the JAX package's default
    stats: HostStats = dataclasses.field(default_factory=HostStats)

    def _fn_vec(self, x):
        return self.fn(x).reshape((self.n_out,))

    def call_host(self, rows: np.ndarray, kind: str) -> np.ndarray:
        """The user's host function at the rows ``(K, n)`` of a NumPy array:
        one call with ``can_batch``, else one a row in order; values cast
        to the rows' dtype, ``(K, n_out)``."""
        K = rows.shape[0]
        st = self.stats
        t0 = time.perf_counter()
        if self.can_batch:
            out = np.asarray(self.fn(rows), dtype=rows.dtype).reshape((K, self.n_out))
            st.calls += 1
        else:
            out = np.empty((K, self.n_out), dtype=rows.dtype)
            for i in range(K):
                out[i] = np.asarray(self.fn(rows[i]), dtype=rows.dtype).reshape(self.n_out)
            st.calls += K
        st.seconds += time.perf_counter() - t0
        st.rows[kind] += K
        return out

    def eval(self, X: torch.Tensor) -> torch.Tensor:
        """Values at sites ``X (..., n)`` -> ``(..., n_out)``."""
        if self.host:
            return host_pass((self,), X)
        return _flat_map(self._fn_vec, X, (self.n_out,))

    def eval_batch_masked(self, X: torch.Tensor, mask) -> torch.Tensor:
        """Values at the sites ``X (..., n)`` where ``mask`` (broadcast
        against ``X.shape[:-1]``) holds, zeros elsewhere. A host function is
        called at the masked rows only (``eval_missing!``'s contract,
        ``Databases.jl:258-277``); a torch function is evaluated everywhere
        (masked rows cost no user code)."""
        if self.host:
            return host_pass((self,), X, mask)
        return self.eval(X)

    def _host_callback(self, X, cb, shape):
        """A host ``jac``/``hess`` callback at every site of ``X``: one
        NumPy site a call."""
        rows = X.reshape((-1, X.shape[-1])).detach().cpu().numpy()
        out = np.stack([np.asarray(cb(r), dtype=rows.dtype).reshape(shape) for r in rows])
        return torch.as_tensor(out, device=X.device).reshape(X.shape[:-1] + shape)

    def jacobian(self, X: torch.Tensor, mask=None) -> torch.Tensor:
        """Jacobians at sites ``X (..., n)`` -> ``(..., n_out, n)``: the user
        callback, else reverse-mode autodiff, and for a host function
        central differences with ``fd_step`` (``DiffFn.jl:56-148``, the
        JAX package's ``VecFun.jacobian`` term by term). ``mask`` limits a
        host function's differences to the masked sites (zeros
        elsewhere)."""
        n = X.shape[-1]
        if self.host:
            if self.jac is not None:
                return self._host_callback(X, self.jac, (self.n_out, n))
            return self._fd_jacobian(X, self.fd_step, mask)
        jac = self.jac if self.jac is not None else jacrev(self._fn_vec)
        return _flat_map(lambda x: jac(x).reshape((self.n_out, n)), X,
                         (self.n_out, n))

    def hessians(self, X: torch.Tensor) -> torch.Tensor:
        """Hessians at sites ``X (..., n)`` -> ``(..., n_out, n, n)``: the
        user callback, else forward-over-reverse autodiff, and for a host
        function central differences of central differences with step
        ``fd_step ** 0.5`` (the JAX package's ``VecFun.hessians``)."""
        n = X.shape[-1]
        if self.host:
            if self.hess is not None:
                return self._host_callback(X, self.hess, (self.n_out, n, n))
            h = torch.tensor(self.fd_step ** 0.5, dtype=X.dtype, device=X.device)
            E = h * torch.eye(n, dtype=X.dtype, device=X.device)
            # (..., 2, n, n): x + h e_j, x - h e_j, then their Jacobians
            Xj = torch.stack([X[..., None, :] + E, X[..., None, :] - E], dim=-3)
            J = self._fd_jacobian(Xj, self.fd_step ** 0.5, None)   # (..., 2, n, m, n)
            H = (J.select(-4, 0) - J.select(-4, 1)) / (2.0 * h)    # (..., n_j, m, n_k)
            return H.transpose(-3, -2)
        hess = self.hess if self.hess is not None else jacfwd(jacrev(self._fn_vec))
        return _flat_map(lambda x: hess(x).reshape((self.n_out, n, n)), X,
                         (self.n_out, n, n))

    def _fd_jacobian(self, X, step, mask):
        """Central differences at every site of ``X (..., n)``: the 2n
        stencil rows of all sites in one host pass."""
        n = X.shape[-1]
        h = torch.tensor(step, dtype=X.dtype, device=X.device)
        E = h * torch.eye(n, dtype=X.dtype, device=X.device)
        sites = torch.cat([X[..., None, :] + E, X[..., None, :] - E], dim=-2)
        if mask is not None:
            mask = _lead_mask(mask, X.shape[:-1])[..., None]
        vals = host_pass((self,), sites, mask, kind="fd")         # (..., 2n, n_out)
        return ((vals[..., :n, :] - vals[..., n:, :]) / (2.0 * h)).transpose(-1, -2)


def _lead_mask(mask, lead):
    """``mask`` with trailing axes added to broadcast against ``lead``."""
    mask = torch.as_tensor(mask)
    return mask.reshape(mask.shape + (1,) * (len(lead) - mask.dim())).expand(lead)


def host_pass(fns, X: torch.Tensor, mask=None, kind: str = "eval") -> torch.Tensor:
    """The host functions ``fns`` at the sites ``X (..., n)`` where ``mask``
    holds (all sites without one): the sites and the mask go to the host in
    one copy, each function is called at the masked rows (row-major order),
    and the values come back in one copy, zeros at the other rows. Returns
    ``(..., sum n_out)``, the functions' outputs side by side."""
    lead, n = X.shape[:-1], X.shape[-1]
    flat = X.reshape((-1, n))
    if mask is None:
        host = flat.detach().cpu().numpy()
        sel = np.arange(host.shape[0])
        m_host = None
    else:
        m = _lead_mask(mask, lead).reshape((-1, 1)).to(X.dtype)
        host = torch.cat([flat, m], dim=-1).detach().cpu().numpy()
        m_host = host[:, n] > 0.5
        sel = np.flatnonzero(m_host)
    rows = np.ascontiguousarray(host[sel, :n])
    outs = []
    for f in fns:
        vals = np.zeros((host.shape[0], f.n_out), dtype=host.dtype)
        if len(sel):
            vals[sel] = f.call_host(rows, kind)
        f.stats.round_trips += 1
        if kind == "eval" and len(lead) >= 1:
            per = (np.ones(host.shape[0], bool) if m_host is None else m_host)
            f.stats.add_lanes(per.reshape((lead[0], -1)).sum(-1))
        outs.append(vals)
    out = torch.from_numpy(np.concatenate(outs, axis=-1)).to(X.device)
    return out.reshape(lead + (out.shape[-1],))


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
        self.composites: list[CompositeFun] = []
        self._order: list[tuple] = []  # addition order over fns + composites
        self._A_eq: list[np.ndarray] = []
        self._b_eq: list[np.ndarray] = []
        self._A_ineq: list[np.ndarray] = []
        self._b_ineq: list[np.ndarray] = []

    def _add(self, fn, n_out, model_cfg, role, jac=None, hess=None,
             max_evals=2 ** 31 - 1, host=False, can_batch=False):
        """Register a function; like the JAX package the default model is an
        RBF surrogate (``RbfConfig()``). ``host``/``can_batch``: a NumPy
        black box (see the module docstring)."""
        cfg = check_ported(RbfConfig() if model_cfg is None else model_cfg)
        self.functions.append(VecFun(fn=fn, n_out=int(n_out), model_cfg=cfg,
                                     role=role, jac=jac, hess=hess,
                                     max_evals=max_evals, host=bool(host),
                                     can_batch=bool(can_batch)))
        self._order.append(("fn", len(self.functions) - 1))
        return len(self.functions) - 1

    def add_objective(self, fn, n_out=1, model_cfg=None, jac=None, hess=None,
                      max_evals=2 ** 31 - 1, host=False, can_batch=False):
        return self._add(fn, n_out, model_cfg, OBJECTIVE, jac, hess, max_evals,
                         host, can_batch)

    def add_exact_objective(self, fn, n_out=1, jac=None, **kw):
        """``add_exact_objective!`` — Jacobians from ``jac``, autodiff, or
        for a host function finite differences."""
        return self._add(fn, n_out, ExactConfig(), OBJECTIVE, jac, **kw)

    def add_rbf_objective(self, fn, n_out=1, **cfg_kw):
        """An objective in an RBF group configured by ``cfg_kw``."""
        return self._add(fn, n_out, RbfConfig(**cfg_kw), OBJECTIVE)

    def add_lagrange_objective(self, fn, n_out=1, **cfg_kw):
        return self._add(fn, n_out, LagrangeConfig(**cfg_kw), OBJECTIVE)

    def add_taylor_objective(self, fn, n_out=1, **cfg_kw):
        return self._add(fn, n_out, TaylorConfig(**cfg_kw), OBJECTIVE)

    # -- nonlinear constraints (``MOP.jl:84-107``): ``fn(x) == 0`` / ``<= 0``
    def add_nl_eq_constraint(self, fn, n_out=1, model_cfg=None, jac=None,
                             hess=None, **kw):
        return self._add(fn, n_out, model_cfg, NL_EQ, jac, hess, **kw)

    def add_nl_ineq_constraint(self, fn, n_out=1, model_cfg=None, jac=None,
                               hess=None, **kw):
        return self._add(fn, n_out, model_cfg, NL_INEQ, jac, hess, **kw)

    # -- linear constraints (``AbstractMOPInterface.jl:354-375``)
    def add_eq_constraint(self, A, b):
        """Rows of ``A x - b == 0``."""
        self._A_eq.append(np.atleast_2d(np.asarray(A, float)))
        self._b_eq.append(np.atleast_1d(np.asarray(b, float)))

    def add_ineq_constraint(self, A, b):
        """Rows of ``A x - b <= 0``."""
        self._A_ineq.append(np.atleast_2d(np.asarray(A, float)))
        self._b_ineq.append(np.atleast_1d(np.asarray(b, float)))

    # -- composite functions (``CompositeVecFun``, ``VecFun.jl``): outer
    #    phi(x, g(x)) over an expensive modelled inner g
    def add_function(self, fn, n_out=1, model_cfg=None, jac=None, hess=None,
                     host=False, can_batch=False):
        """Register an *inner* function: modelled, but not itself an
        objective or constraint, for use in composites (``_add_function!``
        and ``RefVecFun`` sharing, ``MOP.jl:84-107``)."""
        return self._add(fn, n_out, model_cfg, INNER, jac, hess, host=host,
                         can_batch=can_batch)

    def _add_composite(self, outer, inner_index, n_out, role):
        if not 0 <= inner_index < len(self.functions):
            raise ValueError(f"no function {inner_index} to compose")
        if isinstance(outer, str):
            outer = outer_fn_from_expr(outer)
        self.composites.append(CompositeFun(outer=outer, inner_index=int(inner_index),
                                            n_out=int(n_out), role=role,
                                            order=len(self._order)))
        self._order.append(("comp", len(self.composites) - 1))
        return len(self.composites) - 1

    def add_composite_objective(self, outer, inner_index, n_out=1):
        """Objective ``phi(x, g(x))`` with a cheap known ``outer`` and the
        modelled inner ``g`` (added with :meth:`add_function`). The
        surrogate is ``phi(x, m_g(x))`` with chain-rule derivatives
        (``CompositeSurrogate``, ``AbstractSurrogateInterface.jl:193-229``)."""
        return self._add_composite(outer, inner_index, n_out, OBJECTIVE)

    def add_composite_nl_eq_constraint(self, outer, inner_index, n_out=1):
        return self._add_composite(outer, inner_index, n_out, NL_EQ)

    def add_composite_nl_ineq_constraint(self, outer, inner_index, n_out=1):
        return self._add_composite(outer, inner_index, n_out, NL_INEQ)

    @property
    def num_objectives(self):
        return (sum(f.n_out for f in self.functions if f.role == OBJECTIVE)
                + sum(c.n_out for c in self.composites if c.role == OBJECTIVE))


def outer_fn_from_expr(expr: str) -> Callable:
    """An outer function from an expression string over ``x`` and ``g``
    (the reference's ``outer_fn_from_expr``/``make_outer_fun``)::

        mop.add_composite_objective("x[0] + jnp.sum(g**2)", gidx)

    The expression is evaluated with ``torch`` in scope and ``jnp`` and
    ``np`` bound to ``torch``, so the JAX package's strings run unchanged;
    indexing is 0-based.

    .. warning:: Like the reference's ``make_outer_fun``, the string is
       *executed as code* (a bare ``eval`` with no sandboxing): pass only
       trusted expressions."""
    code = compile(expr, "<outer_fn>", "eval")

    def outer(x, g):
        return eval(code, {"torch": torch, "jnp": torch, "np": torch, "x": x, "g": g})

    return outer


@dataclasses.dataclass(frozen=True, eq=False)
class CompositeFun:
    """Composite ``phi(x, g(x))``: cheap known outer, modelled inner."""

    outer: Callable      # (x (n,), g_vals (k,)) -> (n_out,)
    inner_index: int     # index into mop.functions
    n_out: int
    role: str
    order: int


@dataclasses.dataclass(frozen=True, eq=False)
class GroupMember:
    fn_index: int        # index into mop.functions
    group_offset: int    # offset of this function's outputs inside the group
    global_offset: int   # offset inside the role vector (fx / c_e / c_i)
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
        return self.eval_unscaled_batch_masked(X, None)

    @property
    def any_host(self) -> bool:
        return any(f.host for f in self.fns)

    def eval_unscaled_batch_masked(self, X: torch.Tensor, mask,
                                   kind: str = "eval") -> torch.Tensor:
        """Concatenated member values at unscaled sites ``(..., n)``, the
        host members called in one :func:`host_pass` at the rows where
        ``mask`` holds (every row without one; zeros at the others). The
        torch members are evaluated everywhere."""
        if not self.any_host:
            return torch.cat([f.eval(X) for f in self.fns], dim=-1)
        hosts = tuple(f for f in self.fns if f.host)
        vals = iter(torch.split(host_pass(hosts, X, mask, kind),
                                [f.n_out for f in hosts], dim=-1))
        return torch.cat([next(vals) if f.host else f.eval(X) for f in self.fns], dim=-1)

    def jac_unscaled(self, X: torch.Tensor, mask=None) -> torch.Tensor:
        """Concatenated member Jacobians; ``mask`` limits a host member's
        finite differences to the masked sites."""
        return torch.cat([f.jacobian(X, mask) if f.host else f.jacobian(X)
                          for f in self.fns], dim=-2)

    def hess_unscaled(self, X: torch.Tensor) -> torch.Tensor:
        return torch.cat([f.hessians(X) for f in self.fns], dim=-3)


@dataclasses.dataclass(frozen=True, eq=False)
class CompositeSpec:
    """Compiled composite: locates the inner function's outputs."""

    outer: Callable
    role: str
    global_offset: int
    n_out: int
    group_index: int
    group_offset: int
    width: int           # the inner function's n_out

    def _outer_vec(self, x, g):
        v = self.outer(x, g)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
        return v.to(x.dtype).reshape((self.n_out,))

    def inner(self, group_values):
        """The inner function's slice of its group's outputs ``(..., m_g)``."""
        return group_values[..., self.group_offset: self.group_offset + self.width]

    def eval(self, X, G):
        """``phi`` at unscaled sites ``X (..., n)`` and inner values ``G
        (..., width)`` -> ``(..., n_out)``."""
        return _flat_map(self._outer_vec, X, (self.n_out,), G)

    def partials(self, X, G):
        """``(D_x phi (..., n_out, n), D_g phi (..., n_out, width))`` by
        forward-mode autodiff, in ``X``'s dtype (``jacfwd`` returns float64
        partials for an outer that mixes a Python float into float32
        arithmetic)."""
        parts = _flat_map(jacfwd(self._outer_vec, argnums=(0, 1)), X, None, G)
        return tuple(p.to(X.dtype) for p in parts)


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledMOP:
    """Frozen problem (``MOPTyped`` analogue, ``src/MOP.jl:27-82``)."""

    n_vars: int
    lb: np.ndarray
    ub: np.ndarray
    A_eq: np.ndarray     # (p, n)
    b_eq: np.ndarray     # (p,)
    A_ineq: np.ndarray   # (q, n)
    b_ineq: np.ndarray   # (q,)
    groups: tuple        # tuple[GroupSpec]
    m_obj: int
    m_ce: int
    m_ci: int
    composites: tuple = ()  # tuple[CompositeSpec]
    #: a parametric problem's per-lane data (``core/parametric.LaneData``):
    #: its functions evaluate each lane's sites with that lane's theta,
    #: bound by the solver before every trip
    lanes: Optional[object] = None

    @property
    def n_groups(self):
        return len(self.groups)

    @property
    def has_nl_constraints(self):
        return (self.m_ce + self.m_ci) > 0

    @property
    def has_lin_constraints(self):
        return self.A_eq.shape[0] + self.A_ineq.shape[0] > 0

    def role_width(self, role: str) -> int:
        return {OBJECTIVE: self.m_obj, NL_EQ: self.m_ce, NL_INEQ: self.m_ci}[role]

    def scatter_role(self, group_values, role: str, axis: int = -1,
                     composite_values=None) -> torch.Tensor:
        """Per-group outputs -> the ``role`` vector (fx, c_e or c_i), along
        ``axis`` of the group outputs (-1 for values ``(..., m_g)``, -2 for
        Jacobians ``(..., m_g, n)``). ``None`` stands for a group without
        members of the role. ``composite_values``, aligned with
        :attr:`composites`, holds each composite's outputs ``(..., n_out)``
        (or Jacobians ``(..., n_out, n)``), ``None`` for another role."""
        parts = [None] * self.role_width(role)
        ref = None
        for g, vals in zip(self.groups, group_values):
            for mb in g.members:
                if mb.role != role:
                    continue
                ref = vals
                for k in range(mb.n_out):
                    parts[mb.global_offset + k] = vals.select(axis, mb.group_offset + k)
        for cs, vals in zip(self.composites, composite_values or ()):
            if cs.role != role:
                continue
            ref = vals
            for k in range(cs.n_out):
                parts[cs.global_offset + k] = vals.select(axis, k)
        if ref is None:
            ref = next(v for v in group_values if v is not None)
            shape = list(ref.shape)
            shape[axis] = 0
            return ref.new_zeros(shape)
        return torch.stack(parts, dim=axis)

    def composite_values(self, group_values, x):
        """Each composite's outputs at unscaled sites ``x (..., n)`` from the
        group outputs at them."""
        return [cs.eval(x, cs.inner(group_values[cs.group_index]))
                for cs in self.composites]

    def scatter_role_vectors(self, group_values, x=None):
        """Per-group output vectors ``(..., m_g)`` -> ``(fx, c_e, c_i)``;
        ``x`` (unscaled) is needed when composites are present (outer
        functions take it)."""
        comp = self.composite_values(group_values, x) if self.composites else None
        return tuple(self.scatter_role(group_values, r, composite_values=comp)
                     for r in (OBJECTIVE, NL_EQ, NL_INEQ))


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
                    and f.hess is g.hess and f.model_cfg == g.model_cfg
                    and f.host == g.host and f.can_batch == g.can_batch):
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

    # offsets inside each role vector, in the combined order of addition
    # over functions and composites
    role_offsets = {OBJECTIVE: 0, NL_EQ: 0, NL_INEQ: 0, INNER: 0}
    offsets, comp_offsets = {}, {}
    order = mop._order or [("fn", i) for i in range(len(mop.functions))]
    for kind, i in order:
        f = mop.functions[i] if kind == "fn" else mop.composites[i]
        (offsets if kind == "fn" else comp_offsets)[i] = role_offsets[f.role]
        role_offsets[f.role] += f.n_out

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
        groups.append(GroupSpec(
            index=gi, cfg=group_cfgs[gi], fns=tuple(fns), members=tuple(members),
            m=goff, max_evals=max_ev,
            has_objective=any(mop.functions[i].role == OBJECTIVE for i in fn_ids)))
    for i, can in canonical.items():
        if can == i:
            continue
        f = mop.functions[i]
        gi, goff = location[can]
        g = groups[gi]
        groups[gi] = dataclasses.replace(
            g, members=g.members + (GroupMember(i, goff, offsets[i], f.n_out,
                                                f.role),),
            max_evals=min(g.max_evals, f.max_evals, f.model_cfg.max_evals),
            has_objective=g.has_objective or f.role == OBJECTIVE)

    # each composite finds its inner function through the canonical slot of
    # a duplicate registration; a group feeding a composite objective counts
    # toward the evaluation budget
    composites = []
    for ci, c in enumerate(mop.composites):
        gi, goff = location[canonical[c.inner_index]]
        composites.append(CompositeSpec(
            outer=c.outer, role=c.role, global_offset=comp_offsets[ci], n_out=c.n_out,
            group_index=gi, group_offset=goff,
            width=mop.functions[c.inner_index].n_out))
        if c.role == OBJECTIVE and not groups[gi].has_objective:
            groups[gi] = dataclasses.replace(groups[gi], has_objective=True)

    n = mop.n_vars
    rows = lambda A: np.vstack(A) if A else np.zeros((0, n))
    rhs = lambda b: np.concatenate(b) if b else np.zeros((0,))
    return CompiledMOP(
        n_vars=n, lb=mop.lb, ub=mop.ub,
        A_eq=rows(mop._A_eq), b_eq=rhs(mop._b_eq),
        A_ineq=rows(mop._A_ineq), b_ineq=rhs(mop._b_ineq),
        groups=tuple(groups), m_obj=role_offsets[OBJECTIVE],
        m_ce=role_offsets[NL_EQ], m_ci=role_offsets[NL_INEQ],
        composites=tuple(composites))
