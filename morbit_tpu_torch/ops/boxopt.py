"""Box optimization by a grid sweep and projected gradient ascent, batched.

Counterpart of ``morbit_tpu/ops/boxopt.py``: the replacement of the NLopt
calls of the reference (Lagrange polynomial maximization,
``LagrangeModel.jl:270-288``; the Pascoletti-Serafini scalarization,
``descent.jl:478-510``; the local ideal points, ``descent.jl:404-412``).
Every lane sweeps a static low-discrepancy grid of its own box in one
batched call, then refines its best sweep points with fixed-iteration
projected gradient steps whose step sizes adapt multiplicatively; a step is
taken only where it improves (monotone).

``f`` maps sites ``(L, K, n)`` to values ``(L, K)``, one row of lanes. The
gradient comes from ``grad`` (same shapes as the sites) where the caller
has one in closed form, else from autograd through ``f``.
"""

from __future__ import annotations

import numpy as np
import torch

from morbit_tpu_torch.ops.geometry import project_into_box

#: projected gradient steps taken (one per batched step, whatever the
#: number of lanes), on the host; callers set it to 0 and read it
ascent_steps = 0


def halton_grid(n_points: int, n_vars: int) -> np.ndarray:
    """Deterministic unit-cube sample grid (a constant of the solver)."""
    from morbit_tpu_torch.problems.synthetic import halton

    return halton(n_points, n_vars)


def first_argmax(vals: torch.Tensor) -> torch.Tensor:
    """Index of the largest value along the last axis, the lowest index
    among ties and NaN above every number (``jnp.argmax``)."""
    nan = torch.isnan(vals)
    return torch.where(nan.any(-1), torch.argmax(nan.to(vals.dtype), dim=-1),
                       torch.argmax(torch.where(nan, torch.zeros_like(vals), vals), dim=-1))


def top_k(vals: torch.Tensor, k: int):
    """The ``k`` largest values along the last axis and their indices, in
    descending order, the lower index first among equal values (the order
    of ``jax.lax.top_k``; ``torch.topk`` does not promise it)."""
    F, idx = torch.sort(vals, dim=-1, descending=True, stable=True)
    return F[..., :k], idx[..., :k]


def _autograd(f):
    def grad(X):
        with torch.enable_grad():
            Xg = X.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(f(Xg).sum(), Xg)
        return g
    return grad


def maximize_in_box(f, lb, ub, grid_unit: np.ndarray, iters: int = 30,
                    step0: float = 0.1, extra_starts=None, n_starts: int = 1,
                    grad=None):
    """Maximize ``f`` over each lane's box ``[lb, ub]`` (L, n).

    ``grid_unit`` (K, n) are unit-cube points (a tensor on the lanes'
    device, or numpy); ``extra_starts`` (L, S, n)
    are swept ahead of them. ``n_starts > 1`` refines the top sweep points
    together and keeps the best. ``iters=0`` is the sweep and its argmax.
    Returns ``(x_best (L, n), f_best (L,))``."""
    grid = grid_unit
    if not isinstance(grid, torch.Tensor):
        grid = torch.as_tensor(grid, dtype=lb.dtype, device=lb.device)
    pts = lb[:, None, :] + (ub - lb)[:, None, :] * grid
    if extra_starts is not None:
        pts = torch.cat([extra_starts, pts], dim=1)
    vals = f(pts)
    lanes = torch.arange(pts.shape[0], device=pts.device)
    k = min(max(int(n_starts), 1), pts.shape[1])
    if k == 1:
        top = first_argmax(vals)[:, None]
        F = vals[lanes, top[:, 0]][:, None]
    else:
        F, top = top_k(vals, k)
    X = pts[lanes[:, None], top]
    if iters > 0:
        global ascent_steps
        ascent_steps += iters
        g = grad if grad is not None else _autograd(f)
        lo, hi = lb[:, None, :], ub[:, None, :]
        eta = torch.full(F.shape, step0, dtype=lb.dtype, device=lb.device) \
            * (ub - lb).amax(-1)[:, None]
        for _ in range(iters):
            X_try = project_into_box(X + eta[..., None] * g(X), lo, hi)
            F_try = f(X_try)
            better = F_try > F
            X = torch.where(better[..., None], X_try, X)
            F = torch.where(better, F_try, F)
            eta = torch.where(better, eta * 1.5, eta * 0.5)
    best = first_argmax(F)
    return X[lanes, best], F[lanes, best]


def minimize_in_box(f, lb, ub, grid_unit, iters: int = 30, step0: float = 0.1,
                    extra_starts=None, n_starts: int = 1, grad=None):
    neg_grad = None if grad is None else (lambda X: -grad(X))
    x, fneg = maximize_in_box(lambda X: -f(X), lb, ub, grid_unit, iters, step0,
                              extra_starts, n_starts, neg_grad)
    return x, -fneg
