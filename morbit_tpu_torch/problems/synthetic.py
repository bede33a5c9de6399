"""Benchmark problems and Halton starts.

Counterpart of ``morbit_tpu/problems/synthetic.py``: the ZDT suite (ZDT1-4
and 6; ZDT5 is binary-coded and has no box domain), DTLZ1, 2 and 6, the two
parabolas (also under the constrained configuration, and with per-lane
centers for ``parametric_multistart``), the composite
problem of ``examples/composites.py``, the analytic ZDT
fronts and the Halton starts. The objectives
are torch functions of one site ``x (n,)``; the port's ``MOP`` batches and
differentiates them. The Halton sequence is computed the same way as in
the JAX package, so both get bit-equal starts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from morbit_tpu_torch.core.mop import MOP
from morbit_tpu_torch.models.configs import ExactConfig, RbfConfig


# --------------------------------------------------------------------- ZDT
def zdt_bounds(name: str, n: int):
    if name == "zdt4":
        lb = np.concatenate([[0.0], -5.0 * np.ones(n - 1)])
        ub = np.concatenate([[1.0], 5.0 * np.ones(n - 1)])
        return lb, ub
    return np.zeros(n), np.ones(n)


def _pos(v):
    """``jnp.maximum(v, 0.0)`` with its derivative: 1, 1/2 at a tie, 0 below,
    as a factor that multiplies the incoming derivative, so that an
    infinite one (``sqrt`` at 0) becomes NaN below 0 as in JAX (torch's
    ``maximum`` masks it to 0 instead)."""
    slope = (v > 0).to(v.dtype) + 0.5 * (v == 0).to(v.dtype)
    return v * slope


def zdt_objectives(name: str, n: int):
    """Return (f1, f2) as torch functions of x (n,) -> scalar."""

    def g_sum(x):
        return 1.0 + 9.0 / (n - 1) * torch.sum(x[1:])

    if name == "zdt1":
        f1 = lambda x: x[0]
        f2 = lambda x: g_sum(x) * (1.0 - torch.sqrt(_pos(x[0] / g_sum(x))))
    elif name == "zdt2":
        f1 = lambda x: x[0]
        f2 = lambda x: g_sum(x) * (1.0 - (x[0] / g_sum(x)) ** 2)
    elif name == "zdt3":
        f1 = lambda x: x[0]

        def f2(x):
            g = g_sum(x)
            r = x[0] / g
            return g * (1.0 - torch.sqrt(_pos(r))
                        - r * torch.sin(10.0 * math.pi * x[0]))
    elif name == "zdt4":
        f1 = lambda x: x[0]

        def f2(x):
            g = 1.0 + 10.0 * (n - 1) + torch.sum(
                x[1:] ** 2 - 10.0 * torch.cos(4.0 * math.pi * x[1:]))
            return g * (1.0 - torch.sqrt(_pos(x[0] / g)))
    elif name == "zdt6":
        def f1(x):
            return 1.0 - torch.exp(-4.0 * x[0]) * torch.sin(6.0 * math.pi * x[0]) ** 6

        def f2(x):
            g = 1.0 + 9.0 * (torch.sum(x[1:]) / (n - 1)) ** 0.25
            return g * (1.0 - (f1(x) / g) ** 2)
    else:
        raise ValueError(f"unknown ZDT problem {name!r}")
    return f1, f2


def make_zdt(name: str, n: int, model_cfg=None) -> MOP:
    lb, ub = zdt_bounds(name, n)
    mop = MOP(lb, ub)
    f1, f2 = zdt_objectives(name, n)
    if model_cfg is None:
        mop.add_exact_objective(f1)
        mop.add_exact_objective(f2)
    else:
        mop.add_objective(f1, model_cfg=model_cfg)
        mop.add_objective(f2, model_cfg=model_cfg)
    return mop


# --------------------------------------------------------------------- DTLZ
def make_dtlz(which: int, n: int, M: int = 2, model_cfg=None) -> MOP:
    """DTLZ1/DTLZ6 (the reference grid) and DTLZ2."""
    k = n - M + 1
    if k < 1:
        raise ValueError(f"DTLZ needs n >= M, got n={n}, M={M}")

    def g1(x):
        xm = x[M - 1:]
        return 100.0 * (k + torch.sum((xm - 0.5) ** 2
                                      - torch.cos(20.0 * math.pi * (xm - 0.5))))

    def g2(x):
        return torch.sum((x[M - 1:] - 0.5) ** 2)

    def g6(x):
        return torch.sum(_pos(x[M - 1:]) ** 0.1)

    objs = []
    if which == 1:
        for i in range(M):
            def f(x, i=i):
                val = 0.5 * (1.0 + g1(x))
                val = val * torch.prod(x[: M - 1 - i])
                if i > 0:
                    val = val * (1.0 - x[M - 1 - i])
                return val
            objs.append(f)
    elif which == 2:
        for i in range(M):
            def f(x, i=i):
                val = 1.0 + g2(x)
                val = val * torch.prod(torch.cos(0.5 * math.pi * x[: M - 1 - i]))
                if i > 0:
                    val = val * torch.sin(0.5 * math.pi * x[M - 1 - i])
                return val
            objs.append(f)
    elif which == 6:
        # theta-mapped DTLZ2-like front with g6 (Deb et al.)
        for i in range(M):
            def f(x, i=i):
                g = g6(x)
                theta = math.pi / (4.0 * (1.0 + g)) * (1.0 + 2.0 * g * x)
                theta = torch.cat([(0.5 * math.pi * x[0])[None], theta[1:]])
                val = 1.0 + g
                val = val * torch.prod(torch.cos(theta[: M - 1 - i]))
                if i > 0:
                    val = val * torch.sin(theta[M - 1 - i])
                return val
            objs.append(f)
    else:
        raise ValueError("supported: DTLZ1, DTLZ2, DTLZ6")

    mop = MOP(np.zeros(n), np.ones(n))
    for f in objs:
        if model_cfg is None:
            mop.add_exact_objective(f)
        else:
            mop.add_objective(f, model_cfg=model_cfg)
    return mop


def _f1(x):
    return torch.sum((x - 1.0) ** 2)


def _f2(x):
    return torch.sum((x + 1.0) ** 2)


def _j1(x):
    return 2.0 * (x - 1.0)


def _j2(x):
    return 2.0 * (x + 1.0)


def make_two_parabolas(model_cfg=None, lb=None, ub=None) -> MOP:
    """``examples/example_two_parabolas.jl``: f1 = |x - 1|^2, f2 = |x + 1|^2;
    exact objectives with analytic Jacobians unless ``model_cfg`` is given.
    The Pareto set is the segment x_1 = ... = x_n in [-1, 1]."""
    mop = MOP(2) if lb is None else MOP(lb, ub)
    if model_cfg is None:
        mop.add_exact_objective(_f1, jac=_j1)
        mop.add_exact_objective(_f2, jac=_j2)
    else:
        mop.add_objective(_f1, model_cfg=model_cfg)
        mop.add_objective(_f2, model_cfg=model_cfg)
    return mop


def _ball(x):
    return torch.sum(x ** 2) - 2.25


def build_shifted(theta, model_cfg=None) -> MOP:
    """The two parabolas centred at +theta and -theta on [-4, 4]^2, both
    objectives in one multiquadric RBF group unless ``model_cfg`` says
    otherwise (``build_shifted`` of ``tests/test_parametric.py``): the
    builder of ``parametric_multistart``, whose closures capture theta. The
    Pareto set is the segment x = s theta, s in [-1, 1]."""
    cfg = RbfConfig(kernel="multiquadric") if model_cfg is None else model_cfg
    mop = MOP([-4.0, -4.0], [4.0, 4.0])
    mop.add_objective(lambda x: torch.sum((x - theta) ** 2)[None], model_cfg=cfg)
    mop.add_objective(lambda x: torch.sum((x + theta) ** 2)[None], model_cfg=cfg)
    return mop


def make_constrained_two_parabolas(model_cfg=None, lb=(-4.0, -4.0),
                                   ub=(4.0, 4.0)) -> MOP:
    """The constrained configuration (BASELINE config 4, as
    ``tools/bench_constrained.py`` and the constrained golden run it): the
    two parabolas on the box, the linear row ``x1 + x2 <= 1`` and the
    exact nonlinear row ``||x||^2 - 2.25 <= 0``. The constrained Pareto set
    is the segment x1 = x2 in [-1, 0.5]."""
    mop = make_two_parabolas(model_cfg, list(lb), list(ub))
    mop.add_ineq_constraint([[1.0, 1.0]], [1.0])
    mop.add_nl_ineq_constraint(_ball, model_cfg=ExactConfig())
    return mop


# the first 40 are the JAX package's (it covers n <= 40); the port goes on
# to n <= 64, so that the 50-variable ZDT path has Halton starts too
_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59,
           61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127,
           131, 137, 139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193,
           197, 199, 211, 223, 227, 229, 233, 239, 241, 251, 257, 263, 269,
           271, 277, 281, 283, 293, 307, 311]


def _composite_inner(x):
    """g(x) = (||x - a||^2, ||x + a||^2) with a = (1, ..., 1)."""
    return torch.stack([torch.sum((x - 1.0) ** 2), torch.sum((x + 1.0) ** 2)])


def make_composite(model_cfg=None, lb=(-4.0, -4.0), ub=(4.0, 4.0)) -> MOP:
    """The composite walkthrough ``examples/composites.py``: one expensive
    inner function g (``_composite_inner``) modelled once (``model_cfg``),
    the composite objectives g0 and g1 + 0.1 x0 and the composite
    constraint g0 - 9 <= 0, all over g; on [-4, 4]^2 by default."""
    mop = MOP(list(lb), list(ub))
    g = mop.add_function(_composite_inner, n_out=2, model_cfg=model_cfg)
    mop.add_composite_objective(lambda x, v: v[0], g)
    mop.add_composite_objective(lambda x, v: v[1] + 0.1 * x[0], g)
    mop.add_composite_nl_ineq_constraint(lambda x, v: v[0] - 9.0, g)
    return mop


def halton(count: int, dim: int, start_index: int = 1) -> np.ndarray:
    """Halton low-discrepancy sequence (the reference's benchmark starts,
    ``examples/large_scale_benchmarks.jl``)."""
    if dim > len(_PRIMES):
        raise ValueError(f"halton covers dim <= {len(_PRIMES)}, got {dim}")
    out = np.empty((count, dim))
    for j in range(dim):
        b = _PRIMES[j]
        for i in range(count):
            f, r, idx = 1.0, 0.0, start_index + i
            while idx > 0:
                f /= b
                r += f * (idx % b)
                idx //= b
            out[i, j] = r
    return out


def halton_starts(count: int, lb, ub, start_index: int = 1) -> np.ndarray:
    lb = np.asarray(lb)
    ub = np.asarray(ub)
    u = halton(count, lb.shape[0], start_index)
    return lb + (ub - lb) * u


def zdt_front(name: str, count: int = 256) -> np.ndarray:
    """Dense sampling of the analytic Pareto front, shape (count', 2): the
    ``g = 1`` surface with ``f1 = x0`` in [0, 1] (Zitzler et al. 2000),
    filtered to its nondominated subset (ZDT3's and ZDT6's curves hold
    dominated arcs)."""
    f1 = np.linspace(0.0, 1.0, count)
    if name in ("zdt1", "zdt4"):
        f2 = 1.0 - np.sqrt(f1)
    elif name == "zdt2":
        f2 = 1.0 - f1 ** 2
    elif name == "zdt3":
        f2 = 1.0 - np.sqrt(f1) - f1 * np.sin(10.0 * np.pi * f1)
    elif name == "zdt6":
        f1 = 1.0 - np.exp(-4.0 * f1) * np.sin(6.0 * np.pi * f1) ** 6
        f2 = 1.0 - f1 ** 2
    else:
        raise ValueError(f"unknown ZDT problem {name!r}")
    pts = np.stack([f1, f2], axis=1)
    keep = np.ones(len(pts), bool)
    for i in range(len(pts)):
        keep[i] = not np.any(
            (pts[:, 0] <= pts[i, 0]) & (pts[:, 1] <= pts[i, 1])
            & ((pts[:, 0] < pts[i, 0]) | (pts[:, 1] < pts[i, 1])))
    return pts[keep]
