"""Unrolled dense solvers for tiny matrices, batched over leading axes.

Counterpart of ``morbit_tpu/ops/batched_linalg.py``: the same formulas in
the same order, unrolled over the static tiny dimension ``k``, so the
float32 paths of :mod:`morbit_tpu_torch.ops.qp` round like the JAX
package's. Matrices are ``(..., k, k)``; row pivoting uses selects, never
data-dependent indexing.
"""

from __future__ import annotations

import torch

from morbit_tpu_torch.ops import lane_linalg

#: unrolled solves are used up to this size (``GJ_MAX_K`` of the JAX package)
GJ_MAX_K = 24
#: the blocked Gauss-Jordan covers the mid-size band above it (RBF KKT
#: systems of the wide-n path: k = 272 at n = 20), with panels of GJ_PANEL
BLOCKED_GJ_MAX_K = 512
GJ_PANEL = 16


def lane_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over a leading lane axis. A batched matrix product's
    summation order depends on the algorithm cuBLAS picks for the batch
    size, so its result would otherwise change in its last bits with the
    number of lanes (a staged runner's compacted width, a mesh's shard) and
    move a tied or ill-conditioned decision of its lane. So below float64
    the products are summed in float64 and rounded once, and at float64 a
    CUDA tensor takes K7 (:func:`lane_product`, every sum in index order;
    ROADMAP 3.15). Float64 on the CPU stays BLAS's, as the JAX package
    computes it there."""
    if a.dtype == torch.float64:
        return lane_product(a, b)
    return _sum_in_f64(a, b)


def _sum_in_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`lane_matmul` below float64: the library's float64 product of
    the widened operands, rounded once (fault 3.10). Its summation order
    still depends on the batch width at sizes past the port's float32 fits
    (ROADMAP 3.18); the float32 paths keep it so that none of their bits
    move."""
    return (a.double() @ b.double()).to(a.dtype)


def lane_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with broadcast batch axes where :func:`lane_matmul`'s
    float64 sums are not wanted: float64 CUDA tensors take K7 (every sum in
    index order, whatever the batch width; ROADMAP 3.15), every other
    tensor the library's ``a @ b`` as before, so that no float32 or CPU bit
    moves."""
    if a.dtype == torch.float64 and a.device.type != "cpu":
        return lane_linalg.lane_matmul_cuda(a, b)
    return a @ b


def lane_contract(C: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``einsum("...s,bsm->bm...", C, Y)``: a constant ``C`` (..., S)
    applied to each lane's ``Y`` (B, S, m). Float64 CUDA tensors take K7
    (:func:`lane_product`); every other tensor the einsum as before."""
    if Y.dtype == torch.float64 and Y.device.type != "cpu":
        out = lane_linalg.lane_matmul_cuda(Y.transpose(-1, -2),
                                           C.reshape(-1, C.shape[-1]).transpose(0, 1))
        return out.reshape(out.shape[:2] + C.shape[:-1])
    idx = "ijkl"[:C.dim() - 1]
    return torch.einsum(f"{idx}s,bsm->bm{idx}", C, Y)


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Each lane's sum of ``x`` (B, ...) over all but its first axis. On
    the card PyTorch's reduction splits a long sum over more threads when
    it has fewer outputs, so past 64 values its bits depend on the batch
    width (ROADMAP 3.15); float64 CUDA tensors therefore sum in index order
    from +0 by K7 against ones. Every other tensor keeps ``sum``."""
    if x.dtype == torch.float64 and x.device.type != "cpu":
        flat = x.reshape(x.shape[0], 1, -1)
        ones = torch.ones((flat.shape[-1], 1), dtype=x.dtype, device=x.device)
        return lane_linalg.lane_matmul_cuda(flat, ones)[:, 0, 0]
    return x.sum(tuple(range(1, x.dim())))


def lane_matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M (..., k, n) @ v (..., n)`` by :func:`lane_matmul`."""
    return lane_matmul(M, v[..., None])[..., 0]


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


def blocked_gj_solve(A: torch.Tensor, b: torch.Tensor,
                     r: int = GJ_PANEL) -> torch.Tensor:
    """Blocked Gauss-Jordan with partial pivoting for mid-size systems
    (``blocked_gj_solve``, ``batched_linalg.py:77-132`` of the JAX package,
    same order of operations). ``A``: (B, k, k); ``b``: (B, k) or (B, k, m).

    Panels of ``r`` columns are eliminated at once: an unrolled pass over
    the ``(k, r)`` panel picks its ``r`` pivot rows, then the identity
    ``M <- M - F D^-1 M_S`` (``F`` the panel, ``D`` its pivot block, ``S``
    the pivot rows) applies the whole panel as two rank-``r`` products, with
    one-hot products standing in for row gathers. Singular systems give
    inf/nan, like LU."""
    B, k = A.shape[0], A.shape[-1]
    vec = b.dim() == A.dim() - 1
    M = torch.cat([A, b[..., None] if vec else b], dim=-1)   # (B, k, k+m)
    dtype, dev = A.dtype, A.device
    rows = torch.arange(k, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    neg_one = torch.tensor(-1.0, dtype=dtype, device=dev)
    avail = torch.ones((B, k), dtype=torch.bool, device=dev)
    all_onehots = []
    for p0 in range(0, k, r):
        rc = min(r, k - p0)
        F = M[..., p0:p0 + rc]                           # original panel (B, k, rc)
        # ---- within-panel Gauss-Jordan: pivot selection only
        P = F
        onehots = []
        for c in range(rc):
            colv = torch.where(avail, P[..., c].abs(), neg_one)
            oh = rows == torch.argmax(colv, dim=-1)[:, None]      # (B, k)
            onehots.append(oh)
            avail = avail & ~oh
            pivrow = torch.where(oh[..., None], P, zero).sum(-2)  # (B, rc)
            pivrow = pivrow / pivrow[:, c:c + 1]
            P = torch.where(oh[..., None], pivrow[:, None, :],
                            P - P[..., c:c + 1] * pivrow[:, None, :])
        OH = torch.stack(onehots, dim=1).to(dtype)       # (B, rc, k)
        all_onehots.append(OH)
        # ---- block elimination of the whole panel
        PivRows = OH @ M                                 # (B, rc, k+m) original rows
        Dinv = gj_inverse(PivRows[..., p0:p0 + rc])      # (B, rc, rc)
        any_oh = OH.sum(1) > 0.5                         # (B, k)
        E = torch.where(any_oh[..., None], zero, F @ Dinv)      # (B, k, rc)
        M = M - E @ PivRows
        M = torch.where(any_oh[..., None], OH.transpose(-1, -2) @ (Dinv @ PivRows), M)
    X = torch.cat(all_onehots, dim=1) @ M[..., k:]       # row j -> pivot j
    return X[..., 0] if vec else X


def solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Size and dtype dispatch (``solve_small``, ``batched_linalg.py:135-148``
    of the JAX package): at <= 32 bits the unrolled Gauss-Jordan for
    ``k <= GJ_MAX_K`` and the blocked one for ``k <= BLOCKED_GJ_MAX_K``; LU
    otherwise: ``torch.linalg.solve_ex`` (LAPACK on the CPU, as the JAX
    package; cuSOLVER for float32 on the card) or, for float64 CUDA
    tensors, K6 (:func:`morbit_tpu_torch.ops.lane_linalg.lu_solve_nan`),
    whose bits do not depend on the batch width (ROADMAP 3.15). Exactly
    singular systems give nan, like LU in the JAX package, instead of
    raising."""
    k = A.shape[-1]
    if torch.finfo(A.dtype).bits <= 32:
        if k <= GJ_MAX_K:
            return gj_solve(A, b)
        if k <= BLOCKED_GJ_MAX_K:
            return blocked_gj_solve(A, b)
    elif A.device.type != "cpu":
        return lane_linalg.lu_solve_nan(A, b)
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
