"""Unrolled dense solvers for tiny matrices, batched over leading axes.

Counterpart of ``morbit_tpu/ops/batched_linalg.py``: the same formulas in
the same order, unrolled over the static tiny dimension ``k``, so the
float32 paths of :mod:`morbit_tpu_torch.ops.qp` round like the JAX
package's. Matrices are ``(..., k, k)``; row pivoting uses selects, never
data-dependent indexing.
"""

from __future__ import annotations

import torch

#: unrolled solves are used up to this size (``GJ_MAX_K`` of the JAX package)
GJ_MAX_K = 24


def gj_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` by Gauss-Jordan elimination with partial pivoting.

    ``A``: (..., k, k); ``b``: (..., k) or (..., k, m). Singular systems
    give inf/nan, like LU."""
    k = A.shape[-1]
    vec = b.dim() == A.dim() - 1
    Bm = b[..., None] if vec else b
    M = torch.cat([A, Bm], dim=-1)                      # (..., k, k + m)
    rows = torch.arange(k, device=A.device)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    for col in range(k):
        piv = torch.argmax(M[..., col:, col].abs(), dim=-1) + col
        is_piv = (rows == piv[..., None])[..., None]     # (..., k, 1)
        is_col = (rows == col)[:, None]                  # (k, 1)
        row_piv = torch.where(is_piv, M, zero).sum(dim=-2)
        row_col = M[..., col, :]
        M = torch.where(is_col, row_piv[..., None, :],
                        torch.where(is_piv, row_col[..., None, :], M))
        pivrow = M[..., col, :] / M[..., col, col:col + 1]
        factors = M[..., :, col:col + 1]
        M = torch.where(is_col, pivrow[..., None, :],
                        M - factors * pivrow[..., None, :])
    X = M[..., k:]
    return X[..., 0] if vec else X


def gj_inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverse via :func:`gj_solve` against the identity."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return gj_solve(A, eye.expand(A.shape))


def solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Size and dtype dispatch (``solve_small``, ``batched_linalg.py:135-148``
    of the JAX package): unrolled Gauss-Jordan at <= 32 bits and
    ``k <= GJ_MAX_K``, LU (``torch.linalg.solve``) at 64 bits. Exactly
    singular systems give nan, like LU in the JAX package, instead of
    raising. A 32-bit system with ``k > GJ_MAX_K`` needs the blocked
    Gauss-Jordan of the wide-n slice and raises."""
    k = A.shape[-1]
    if torch.finfo(A.dtype).bits <= 32:
        if k <= GJ_MAX_K:
            return gj_solve(A, b)
        raise NotImplementedError(
            f"a {k}x{k} system at {A.dtype} needs the blocked Gauss-Jordan "
            f"solve of the wide-n slice (k <= {GJ_MAX_K} is ported)")
    vec = b.dim() == A.dim() - 1
    x, info = torch.linalg.solve_ex(A, b[..., None] if vec else b)
    x = torch.where((info != 0).reshape(info.shape + (1, 1)),
                    torch.full_like(x, float("nan")), x)
    return x[..., 0] if vec else x


def chol_factor(M: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky of SPD (..., k, k) matrices; returns lower L.

    Breakdown (non-SPD input) yields nan entries."""
    k = M.shape[-1]
    L = [[None] * k for _ in range(k)]
    for j in range(k):
        s = M[..., j, j]
        for t in range(j):
            s = s - L[j][t] * L[j][t]
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, k):
            s2 = M[..., i, j]
            for t in range(j):
                s2 = s2 - L[i][t] * L[j][t]
            L[i][j] = s2 / L[j][j]
    zero = torch.zeros_like(M[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(k)], -1)
            for i in range(k)]
    return torch.stack(rows, dim=-2)


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L L' x = b`` by unrolled forward/back substitution.

    ``L``: (..., k, k) lower triangular; ``b``: (..., k)."""
    k = L.shape[-1]
    y = [None] * k
    for i in range(k):
        s = b[..., i]
        for t in range(i):
            s = s - L[..., i, t] * y[t]
        y[i] = s / L[..., i, i]
    x = [None] * k
    for i in reversed(range(k)):
        s = y[i]
        for t in range(i + 1, k):
            s = s - L[..., t, i] * x[t]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)
