"""The structure K3's block-per-lane instance rests on, checked on the twin.

The CUDA kernel (``csrc/rbf_round4.cu``) skips every term that is an exact
zero of the round-4 state's structure and never writes the identity/zero
padding. These tests hold the plain twin
(``morbit_tpu_torch/models/rbf_round4.py``) to that structure at the wide
path's shapes (n = 20, max_points = 231, pd = 21), bit for bit, and check
the live-size operation count that ``chip_smoke.py`` reports as K3's bound
against a count replayed candidate by candidate from the twin's outputs.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from morbit_tpu_torch.models import rbf_round4 as r4
from morbit_tpu_torch.ops.affine import seq_dot
from morbit_tpu_torch.ops.rbf import apply_kernel, poly_basis

N_WIDE, MAXN, PD = 20, 231, 21
BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def _bits(t):
    return t.contiguous().view(BITS[t.dtype])


def _setup(N0, dtype, B=2, seed=0):
    """The twin's set-up state at the wide shapes: sites, Phi, Q, R."""
    rng = np.random.default_rng(seed + N0)
    sites = torch.as_tensor(rng.uniform(0, 1, (B, MAXN, N_WIDE)), dtype=dtype)
    N = torch.full((B,), N0, dtype=torch.int32)
    live = torch.arange(MAXN)[None, :] < N[:, None]
    sites = torch.where(live[..., None], sites, torch.zeros((), dtype=dtype))
    d = sites[:, :, None, :] - sites[:, None, :, :]
    eye = torch.eye(MAXN, dtype=dtype)
    Phi = torch.where(live[:, :, None] & live[:, None, :],
                      apply_kernel("cubic", seq_dot(d, d), 3), eye)
    Pi0 = torch.where(live[..., None], poly_basis(sites, 1), torch.zeros((), dtype=dtype))
    Q, R = r4._masked_householder_qr(Pi0)
    return sites, N, Phi, Q, R


@pytest.mark.parametrize("N0", [0, 5, 21])
def test_householder_q_is_identity_outside_its_block(N0):
    """Q differs from the identity only in its leading max(N0, pd) block,
    bit for bit (no -0 outside it)."""
    _, _, _, Q, _ = _setup(N0, torch.float64)
    k = max(N0, PD)
    eye = torch.eye(MAXN, dtype=torch.float64).expand_as(Q)
    outside = torch.ones((MAXN, MAXN), dtype=torch.bool)
    outside[:k, :k] = False
    assert torch.equal(_bits(Q)[:, outside], _bits(eye)[:, outside])
    # and Q is the identity also inside the block past N0 (no reflection
    # reaches rows or columns >= N0)
    live = torch.arange(MAXN) < N0
    off = ~(live[:, None] & live[None, :])
    assert torch.equal(_bits(Q)[:, off], _bits(eye)[:, off])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N0", [0, 5, 21, 40])
def test_candidate_products_are_zero_past_the_count(N0, dtype):
    """For a candidate against the set-up state, Qg = Q g and PQg = Phi Qg
    are exactly +0 past row N (the kernel computes them on the live rows
    only), computed with the twin's own helpers in its order."""
    sites, N, Phi, Q, R = _setup(N0, dtype, seed=1)
    B = sites.shape[0]
    xi = torch.as_tensor(np.random.default_rng(2).uniform(0, 1, (B, N_WIDE)), dtype=dtype)
    gvec = torch.zeros((B, MAXN), dtype=dtype)
    idxN = torch.arange(MAXN)
    row, R_rot = poly_basis(xi, 1), R
    for j in range(PD):
        cth, sth = r4._givens(R_rot, row, j, N, PD, dtype)
        Rj = R_rot[:, j]
        R_rot = torch.where((idxN == j)[None, :, None],
                            (cth[:, None] * Rj + sth[:, None] * row)[:, None, :], R_rot)
        row = -sth[:, None] * Rj + cth[:, None] * row
        gvec = cth[:, None] * gvec - sth[:, None] * (idxN == j).to(dtype)
    Qg = r4._mv(Q, gvec)
    PQg = r4._mv(Phi, Qg)
    zero = torch.zeros((), dtype=dtype)
    for t in (Qg, PQg):
        past = _bits(t[:, N0:])
        assert torch.equal(past, _bits(zero.expand_as(t[:, N0:])))
    if N0 >= PD:
        assert bool((Qg[:, :N0] != 0).any())


def _brute_force_work(cand, accepted, count, n, max_points):
    """K3's live-size operation count, candidate by candidate."""
    pd = n + 1
    ops, tested = 0, 0
    for b in range(cand.shape[0]):
        N0 = int(count[b])
        N, zc = N0, 0
        if N0 < max_points:
            ops += cs.round4_setup_ops(N0, n, pd)
        for c in range(cand.shape[1]):
            if not (bool(cand[b, c]) and N < max_points):
                assert not bool(accepted[b, c])
                continue
            tested += 1
            ops += cs.round4_test_ops(N, zc, N0, n, pd)
            if bool(accepted[b, c]):
                ops += cs.round4_accept_ops(N, zc, pd)
                N, zc = N + 1, zc + 1
    return ops, tested


@pytest.mark.parametrize("fill", ["partial", "to_max"])
def test_round4_work_matches_a_replayed_count(fill):
    """``chip_smoke.round4_work`` (vectorised over the replayed acceptance
    sequence) equals the count made candidate by candidate from the twin's
    outputs, lanes that fill to max_points included."""
    n, maxN, C, B = 4, 15, 40, 6
    X, cand, init, count, _ = cs.round4_case(np.random.default_rng(3), B, C, n, maxN,
                                             0.3, maxN + n)
    if fill == "to_max":
        cand[:] = True
        count = np.array([1, 2, 3, 10, 15, 16], np.int32)
        live = np.arange(maxN + n)[None, :] < count[:, None]
        init = np.where(live[..., None], np.random.default_rng(4).uniform(0, 1, init.shape),
                        0.0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    args = (t(X), torch.as_tensor(cand), t(init), torch.as_tensor(count, dtype=torch.int32))
    kw = dict(kernel="cubic", param=3, poly_deg=1, max_points=maxN, chol_pivot=1e-7)
    acc, N = r4.run_round4(*args, **kw)
    ops, nbytes = cs.round4_work(args, kw, acc, N)
    want, tested = _brute_force_work(args[1], acc, args[3], n, maxN)
    assert ops == want
    assert nbytes == (tested * n * 8 + B * C * 2 + int(args[3].sum()) * n * 8
                      + B * (8 + 8))
    if fill == "to_max":
        assert int(N[3]) == maxN and int(acc[3].sum()) == maxN - 10


@pytest.mark.parametrize("itemsize", [4, 8])
def test_round4_and_gram_blocks_fit_shared_memory(itemsize):
    """K3's block instance at every max_points <= 512 (pd <= 33) and K4 at
    every P <= 512 with n <= 32 fit the H100's 227 KB a block."""
    from morbit_tpu_torch.ops import cuda_build, dense_kernels, prepare_fused

    r4_max = max(prepare_fused.round4_wide_smem_bytes(m, pd, itemsize)
                 for m in range(1, prepare_fused.ROUND4_WIDE_MAX_POINTS + 1)
                 for pd in (0, 1, 33))
    gram_max = max(dense_kernels.gram_smem_bytes(P, n, itemsize)
                   for P in range(1, 513) for n in range(1, 33))
    assert r4_max <= cuda_build.SMEM_LIMIT
    assert gram_max <= cuda_build.SMEM_LIMIT


def test_phase_probe_finds_its_marks():
    """``tools/round4_phases.py`` instruments the wide kernel at its phase
    comments: each mark once, and the final write of N."""
    from morbit_tpu_torch.ops import prepare_fused
    from morbit_tpu_torch.tools.round4_phases import instrument

    text = instrument(prepare_fused.ROUND4_SOURCE.read_text())
    for k in (1, 2, 3):
        assert text.count(f"MORBIT_PROBE({k});") == 1
    assert text.count("MORBIT_PROBE_END;") == 2
