"""Affinely independent point selection (masked greedy QR-projection filter).

Counterpart of ``morbit_tpu/ops/affine.py`` (the reference's
``AffinelyIndependentPointFilter``, ``src/models/AffinelyIndependentPoints.jl``),
batched over a leading lane axis:

* the first pick of a call is the candidate with the largest
  ``||s - x0||_inf`` and is accepted unconditionally (``:51-69``);
* every further pick maximizes ``||Z Z' (s - x0)||_inf``, with the columns
  of ``Z`` spanning the orthogonal complement of the picked shifted sites,
  normalized to unit inf-norm (``:71-106``, ``:4-11``), and is accepted
  while that exceeds ``pivot_val``.

The complement comes from an unpivoted Householder QR with LAPACK's sign
convention, as in the JAX package: a sign flip would change the improving
directions and every later round-3 site. Ties in a pick go to the first
database row, as ``jnp.argmax`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def seq_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of ``a * b`` over the last axis, added in index order, one
    rounding per operation: the summation order of the CUDA kernels
    (``csrc/rbf_selection.cu``, ``csrc/rbf_round4.cu``, built without
    multiply-add contraction), so that twin and kernel round alike."""
    prod = a * b      # each product rounded once, as a[..., i] * b[..., i]
    acc = torch.zeros_like(prod[..., 0])
    for i in range(prod.shape[-1]):
        acc = acc + prod[..., i]
    return acc


def householder_q(Y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Full Q factor of the unpivoted Householder QR of ``Y[:, :, :k]``.

    ``Y`` (B, n, n) zero-padded beyond each lane's ``k`` (B,); columns
    ``>= k`` act as identity reflections, so ``Q[:, :, k:]`` spans the
    orthogonal complement of the valid columns."""
    B, n, kmax = Y.shape
    dtype, dev = Y.dtype, Y.device
    Q = torch.eye(n, dtype=dtype, device=dev).expand(B, n, n)
    A = Y
    idx = torch.arange(n, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    # a reflection at j >= k is the identity on every lane: stop at max(k)
    # (one host sync)
    for j in range(min(kmax, int(k.max()) if k.numel() else 0)):
        x = torch.where(idx >= j, A[:, :, j], zero)
        normx = torch.sqrt(seq_dot(x, x))
        sgn = torch.where(A[:, j, j] >= 0, 1.0, -1.0).to(dtype)
        alpha = -sgn * normx
        v = torch.where(idx == j, x - alpha[:, None], x)
        vnorm2 = seq_dot(v, v)
        active = (j < k) & (vnorm2 > 0) & (normx > 0)
        beta = 2.0 / torch.where(vnorm2 > 0, vnorm2, 1.0)
        # H = I - beta v v';  A <- H A,  Q <- Q H (inactive: identity)
        vA = seq_dot(v[:, :, None].transpose(-1, -2), A.transpose(-1, -2))  # (B, kmax)
        A = torch.where(active[:, None, None],
                        A - beta[:, None, None] * (v[:, :, None] * vA[:, None, :]), A)
        Qv = seq_dot(Q, v[:, None, :])                      # (B, n)
        Q = torch.where(active[:, None, None],
                        Q - beta[:, None, None] * (Qv[:, :, None] * v[:, None, :]), Q)
    return Q


def orthogonal_complement(Y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Complement basis with inf-norm-normalized columns (``(B, n, n)``;
    columns ``>= k`` are the complement, ``_orthogonal_complement_matrix``,
    ``AffinelyIndependentPoints.jl:4-11``)."""
    Q = householder_q(Y, k)
    norms = Q.abs().amax(dim=-2)
    return Q / torch.where(norms > 0, norms, torch.ones_like(norms))[:, None, :]


class AffineSelection(NamedTuple):
    order: torch.Tensor     # (B, n) int32 seed row per pick slot (-1 unused)
    n_picked: torch.Tensor  # (B,) int32 accepted count of this call
    Y: torch.Tensor         # (B, n, n) shifted picks as zero-padded columns
    k: torch.Tensor         # (B,) int32 valid columns of Y, warm start included
    Z: torch.Tensor         # (B, n, n) complement basis, columns >= k valid


def affinely_independent_points(x0, seeds, seed_mask, pivot_val, n_pick,
                                Y_init=None, k_init=None) -> AffineSelection:
    """Greedy masked selection of up to ``n_pick`` (B,) affinely independent
    seeds per lane (``affinely_independent_points``,
    ``morbit_tpu/ops/affine.py:154-228``).

    ``x0`` (B, n); ``seeds`` (B, cap, n) with ``seed_mask`` (B, cap);
    ``pivot_val`` (B,). ``Y_init``/``k_init`` warm-start the span from an
    earlier round (round 2 continues round 1's, ``RbfModel.jl:251-265``)."""
    B, n = x0.shape
    dtype, dev = x0.dtype, x0.device
    # rows past every lane's last seed never score: leave them out (one host
    # sync; the scores, picks and their rows are unchanged)
    live = seed_mask.any(0).nonzero()
    live = int(live[-1]) + 1 if live.numel() else 1
    seeds, seed_mask = seeds[:, :live], seed_mask[:, :live]
    shifted = (seeds - x0[:, None, :]) * seed_mask.to(dtype)[..., None]

    Y = torch.zeros((B, n, n), dtype=dtype, device=dev) if Y_init is None else Y_init
    k = (torch.zeros((B,), dtype=torch.int32, device=dev) if k_init is None
         else k_init.to(torch.int32))
    Z = orthogonal_complement(Y, k)

    cap = seeds.shape[1]
    selected = torch.zeros((B, cap), dtype=torch.bool, device=dev)
    order = torch.full((B, n), -1, dtype=torch.int32, device=dev)
    n_picked = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    slot_ids = torch.arange(n, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=dtype, device=dev)

    for _ in range(n):
        avail = seed_mask & ~selected
        first = n_picked == 0
        Zm = Z * (slot_ids[None, :] >= k[:, None]).to(dtype)[:, None, :]
        # proj[m] = sum_c s_c Zm[c, m], then Zm (proj), in the kernel's order
        proj = seq_dot(shifted[:, :, None, :], Zm.transpose(-1, -2)[:, None])
        proj_back = seq_dot(proj[:, :, None, :], Zm[:, None])  # (B, cap, n)
        score_proj = proj_back.abs().amax(-1)
        score_norm = shifted.abs().amax(-1)
        score = torch.where(first[:, None], score_norm, score_proj)
        score = torch.where(avail, score, neg_inf)

        best = torch.argmax(score, dim=-1)                  # first maximum
        best_val = score.amax(-1)
        have_any = avail.any(-1)
        passes = have_any & (first | (best_val > pivot_val))
        accept = passes & ~done & (n_picked < n_pick) & (k < n)

        best_row = torch.gather(shifted, 1, best[:, None, None].expand(B, 1, n))[:, 0]
        selected = selected | ((torch.arange(cap, device=dev)[None, :]
                                == best[:, None]) & accept[:, None])
        order = torch.where((slot_ids[None, :] == n_picked[:, None]) & accept[:, None],
                            best[:, None].to(torch.int32), order)
        Y = torch.where(((slot_ids[None, :] == k[:, None]) & accept[:, None])[:, None, :],
                        best_row[:, :, None], Y)
        k_new = torch.where(accept, k + 1, k)
        Z = torch.where(accept[:, None, None], orthogonal_complement(Y, k_new), Z)
        k = k_new
        n_picked = torch.where(accept, n_picked + 1, n_picked)
        done = done | ~accept
    return AffineSelection(order, n_picked, Y, k, Z)


def improving_directions_from(Z: torch.Tensor, k: torch.Tensor):
    """Reversed complement columns as improving directions
    (``reverse(eachcol(Z))``, ``RbfModel.jl:231-237``): row ``i`` of the
    result is column ``n-1-i`` of ``Z``; the valid count is ``n - k``."""
    n = Z.shape[-1]
    dirs = torch.flip(Z, dims=(-1,)).transpose(-1, -2).contiguous()
    return dirs, (n - k).to(torch.int32)
