"""RBF round 4: Cholesky-bounded additional training points (plain twin of K3).

Counterpart of ``morbit_tpu/models/rbf_round4.py`` (the reference's
``_rbf_round4``, ``src/models/RbfModel.jl:352-499``, Wild's scheme): starting
from the affinely independent set of rounds 1-3, database points inside the
wide box are accepted one by one, in database order, while the Cholesky
factor of ``Z' Phi Z`` stays bounded:

    tau^2 = sigma - ||L^-1 v||^2  >  theta_pivot_cholesky^4

with the Givens update of the polynomial block's QR factor and rank-1
updates of ``Z``, ``L^-1`` and ``Phi`` (``:429-494``; the factor ``L``
itself is never read by the test, so it is not kept).

:func:`run_round4` is the batched plain version of the CUDA kernel K3
(``morbit_tpu_torch/csrc/rbf_round4.cu``). It scans the candidates in order
and tests each against the current state. The JAX package tests a whole
wave of candidates at once and accepts the first that passes; since the
state changes only at an acceptance, both give the same acceptance
sequence. The state lives in identity/zero-padded ``(maxN, maxN)`` buffers
with per-lane counts; ``maxN`` is the width of ``init_sites``. Sums run in
index order (:func:`morbit_tpu_torch.ops.affine.seq_dot`), as the kernel
adds them, so that the two round alike.
"""

from __future__ import annotations

import torch

from morbit_tpu_torch.ops.affine import seq_dot
from morbit_tpu_torch.ops.rbf import apply_kernel, poly_basis, poly_dim


def _masked_householder_qr(Pi: torch.Tensor):
    """QR of the zero-row-padded (B, maxN, pd) polynomial block; returns
    (Q (B, maxN, maxN), R (B, maxN, pd)). Zero rows never enter a
    reflection, so Q is the identity there."""
    B, maxN, pd = Pi.shape
    dtype, dev = Pi.dtype, Pi.device
    Q = torch.eye(maxN, dtype=dtype, device=dev).expand(B, maxN, maxN)
    A = Pi
    idx = torch.arange(maxN, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for j in range(pd):
        x = torch.where(idx >= j, A[:, :, j], zero)
        normx = torch.sqrt(seq_dot(x, x))
        sgn = torch.where(A[:, j, j] >= 0, 1.0, -1.0).to(dtype)
        v = torch.where(idx == j, x - (-sgn * normx)[:, None], x)
        vnorm2 = seq_dot(v, v)
        active = ((normx > 0) & (vnorm2 > 0))[:, None, None]
        beta = (2.0 / torch.where(vnorm2 > 0, vnorm2, 1.0))[:, None, None]
        vA = seq_dot(v[:, None, :], A.transpose(-1, -2))    # (B, pd)
        A = torch.where(active, A - beta * (v[:, :, None] * vA[:, None, :]), A)
        Qv = seq_dot(Q, v[:, None, :])                      # (B, maxN)
        Q = torch.where(active, Q - beta * (Qv[:, :, None] * v[:, None, :]), Q)
    return Q, A


def _givens(R, row, j, N, pd, dtype):
    """Plane (j, new) of the rotation that folds ``row`` into ``R``
    (``nullify_last_row``, ``utilities.jl:437-448``): (cos, sin)."""
    active = j < torch.clamp(N, max=pd)
    a = R[:, j, j]
    b = row[:, j]
    r = torch.sqrt(a * a + b * b)
    has = (r > 0) & active
    safe = torch.where(r > 0, r, torch.ones_like(r))
    cth = torch.where(has, a / safe, torch.ones_like(a))
    sth = torch.where(has, b / safe, torch.zeros_like(b))
    return cth, sth


def _mv(M, v):
    """(B, r, c) @ (B, c) summed in index order."""
    return seq_dot(M, v[:, None, :])


def run_round4(X, cand, init_sites, n_init, kernel: str, param,
               poly_deg: int, max_points: int, chol_pivot: float):
    """Accept extra candidates in database order, per lane.

    ``X`` (B, C, n) candidate sites, ``cand`` (B, C) bool, ``init_sites``
    (B, maxN, n) rounds-1-3 sites (rows past ``n_init`` ignored), ``n_init``
    (B,) int; ``param`` a number (exponent kernels) or (B,) tensor;
    ``chol_pivot`` is ``theta_pivot_cholesky^2``, tested against its square.
    Returns ``accepted`` (B, C) bool and the final count ``N`` (B,) int32."""
    B, maxN, n = init_sites.shape
    C = X.shape[1]
    dtype, dev = init_sites.dtype, init_sites.device
    pd = poly_dim(n, poly_deg)
    idxN = torch.arange(maxN, device=dev)
    eye = torch.eye(maxN, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    eps = torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny
    pivot2 = torch.tensor(chol_pivot, dtype=dtype, device=dev) ** 2
    if isinstance(param, torch.Tensor):
        param = param.to(dtype)

    N = n_init.to(torch.int32)
    row_mask0 = idxN[None, :] < N[:, None]
    # the initial state from the live rows (max(N) of them; past them Phi is
    # the identity, the polynomial block zero and Q the identity, as the
    # full-size sums and reflections leave them, whose extra terms are exact
    # zeros)
    kn = min(maxN, max(int(N.max()), 1))
    live = init_sites[:, :kn]
    d0 = live[:, :, None, :] - live[:, None, :, :]
    Phi = eye.repeat(B, 1, 1)
    Phi[:, :kn, :kn] = torch.where(row_mask0[:, :kn, None] & row_mask0[:, None, :kn],
                                   apply_kernel(kernel, seq_dot(d0, d0), param), eye[:kn, :kn])
    phi0 = apply_kernel(kernel, torch.zeros((B,), dtype=dtype, device=dev), param)
    if pd > 0:
        Pi0 = torch.where(row_mask0[..., None], poly_basis(init_sites, poly_deg), zero)
        kl = min(maxN, max(kn, pd))
        Q = eye.repeat(B, 1, 1)
        Q[:, :kl, :kl], R_live = _masked_householder_qr(Pi0[:, :kl])
        R = torch.cat([R_live, Pi0[:, kl:]], 1)
    else:
        Q = eye.expand(B, maxN, maxN)
        R = torch.zeros((B, maxN, 0), dtype=dtype, device=dev)
    sites = init_sites
    Z = torch.zeros((B, maxN, maxN), dtype=dtype, device=dev)
    zc = torch.zeros((B,), dtype=torch.int32, device=dev)
    Linv = eye.expand(B, maxN, maxN)
    accepted = torch.zeros((B, C), dtype=torch.bool, device=dev)

    # a column that is no lane's candidate changes nothing: scan only the
    # others (one host sync)
    for k, c in enumerate(cand.any(0).nonzero().flatten().tolist()):
        xi = X[:, c]
        # ---- tau^2 of candidate c against the current state
        diff = sites - xi[:, None, :]
        phi_xi = apply_kernel(kernel, seq_dot(diff, diff), param)
        phi_xi = torch.where(idxN[None, :] < N[:, None], phi_xi, zero)
        gvec = torch.zeros((B, maxN), dtype=dtype, device=dev)
        ghat = torch.ones((B,), dtype=dtype, device=dev)
        R_rot = R
        if pd > 0:
            row = poly_basis(xi, poly_deg)
            for j in range(pd):
                cth, sth = _givens(R_rot, row, j, N, pd, dtype)
                Rj = R_rot[:, j]
                R_rot = torch.where((torch.arange(maxN, device=dev) == j)[None, :, None],
                                    (cth[:, None] * Rj + sth[:, None] * row)[:, None, :],
                                    R_rot)
                row = -sth[:, None] * Rj + cth[:, None] * row
                gvec = cth[:, None] * gvec - sth[:, None] * (idxN == j).to(dtype)
                ghat = cth * ghat
            rank_ok = torch.where(N < pd,
                                  torch.sqrt(seq_dot(row, row)) > 10 * eps,
                                  torch.ones_like(N, dtype=torch.bool))
        else:
            row = torch.zeros((B, 0), dtype=dtype, device=dev)
            rank_ok = torch.ones_like(N, dtype=torch.bool)
        # each sum runs over the live prefix only: past it every term is an
        # exact zero of the state's structure times a finite factor (g past
        # pd; Qg, phi_xi and Z's rows past max(N, pd) or N; v and Lv past
        # zc), and adding +-0 to a sum that starts at +0 never changes it
        # (the kernel's argument), so the sums keep their bits
        kp, kn = min(maxN, max(pd, 1)), min(maxN, max(int(N.max()), 1))
        kq, kz = min(maxN, max(kn, pd)), min(maxN, max(int(zc.max()), 1))
        Qg = _mv(Q[..., :kp], gvec[:, :kp])
        zmask = idxN[None, :] < zc[:, None]
        PhiQg = _mv(Phi[..., :kq], Qg[:, :kq])
        tq = PhiQg + phi_xi * ghat[:, None]
        v = torch.where(zmask, _mv(Z.transpose(-1, -2)[..., :kn], tq[:, :kn]), zero)
        sigma = (seq_dot(Qg[:, :kq], PhiQg[:, :kq])
                 + 2.0 * ghat * seq_dot(phi_xi[:, :kq], Qg[:, :kq]) + ghat * ghat * phi0)
        Lv = torch.where(zmask, _mv(Linv[..., :kz], v[:, :kz]), zero)
        tau2 = sigma - seq_dot(Lv[:, :kz], Lv[:, :kz])
        ok = cand[:, c] & rank_ok & (tau2 > pivot2) & (N < max_points)

        # ---- acceptance (applied on the lanes where ok)
        tau = torch.sqrt(torch.clamp(tau2, min=tiny))
        slotN = torch.clamp(N, 0, maxN - 1)
        zslot = torch.clamp(zc, 0, maxN - 1)
        hitN = idxN[None, :] == slotN[:, None]               # (B, maxN)
        hitZ = idxN[None, :] == zslot[:, None]
        sites_n = torch.where(hitN[..., None], xi[:, None, :], sites)
        Qn, Rn = Q, R
        if pd > 0:
            Rq, rowq = R, poly_basis(xi, poly_deg)
            for j in range(pd):
                cth, sth = _givens(Rq, rowq, j, N, pd, dtype)
                Rj = Rq[:, j]
                Rq = torch.where((idxN == j)[None, :, None],
                                 (cth[:, None] * Rj + sth[:, None] * rowq)[:, None, :],
                                 Rq)
                rowq = -sth[:, None] * Rj + cth[:, None] * rowq
                colj = Qn[:, :, j]
                colN = (Qn * hitN[:, None, :].to(dtype)).sum(-1)
                Qn = torch.where((idxN == j)[None, None, :],
                                 (cth[:, None] * colj + sth[:, None] * colN)[:, :, None],
                                 Qn)
                Qn = torch.where(hitN[:, None, :],
                                 (-sth[:, None] * colj + cth[:, None] * colN)[:, :, None],
                                 Qn)
            Rn = torch.where(hitN[..., None], row[:, None, :], R_rot)
        zcol = torch.where(hitN, ghat[:, None], Qg)
        Zn = torch.where(hitZ[:, None, :], zcol[:, :, None], Z)
        linv_row = -_mv(Linv.transpose(-1, -2)[..., :kz], Lv[:, :kz]) / tau[:, None]
        Linvn = torch.where(hitZ[:, :, None],
                            torch.where(zmask, linv_row, zero)[:, None, :], Linv)
        Linvn = torch.where(hitZ[:, :, None] & hitZ[:, None, :],
                            (1.0 / tau)[:, None, None], Linvn)
        Phin = torch.where(hitN[:, :, None], phi_xi[:, None, :], Phi)
        Phin = torch.where(hitN[:, None, :], phi_xi[:, :, None], Phin)
        Phin = torch.where(hitN[:, :, None] & hitN[:, None, :],
                           phi0.expand(B)[:, None, None], Phin)

        sel = ok[:, None, None]
        sites = torch.where(sel, sites_n, sites)
        Q = torch.where(sel, Qn, Q)
        R = torch.where(sel, Rn, R)
        Z = torch.where(sel, Zn, Z)
        Linv = torch.where(sel, Linvn, Linv)
        Phi = torch.where(sel, Phin, Phi)
        N = torch.where(ok, N + 1, N)
        zc = torch.where(ok, zc + 1, zc)
        accepted[:, c] = ok
        # once every lane is full no later candidate can pass (one host sync
        # per 16 scanned columns)
        if k % 16 == 15 and not bool((N < max_points).any()):
            break
    return accepted, N
