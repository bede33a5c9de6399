"""K6's and K7's plain twins (``morbit_tpu_torch/ops/lane_linalg.py``) on the
CPU, and the CPU routing of the float64 solves and lane products.

* K6's twin (``lane_lu_factor_plain`` + ``lane_lu_solve_plain``) against the
  JAX package's ``solve_small`` (jitted, CPU) and ``torch.linalg.solve``
  at the port's sizes, float64, well-conditioned systems, within rtol
  1e-10; K7's twin against ``a @ b`` within 1e-13 relative;
* each twin equal to the bit across batch widths 1, 2 and 16 (lane i of a
  batch of w against lane i of the batch of 16);
* an exactly singular lane gives nan through ``solve_small``'s contract
  (``lu_solve_nan``) while its neighbours solve;
* on the CPU ``solve_small``, ``_polish`` and ``lane_matmul`` still make the
  library calls they made before (LAPACK and BLAS, as the JAX package does
  on the CPU), to the bit, and never reach the twins.
"""

import unittest.mock

import jax
import numpy as np
import pytest
import torch

from morbit_tpu.ops.batched_linalg import solve_small as jax_solve_small
from morbit_tpu_torch.ops import batched_linalg, lane_linalg as ll
from morbit_tpu_torch.ops.qp import _polish

WIDTHS = (1, 2, 16)
#: K6's launches replaced by its twins, for ``lu_solve_nan`` on the CPU
TWINS = dict(factor=ll.lane_lu_factor_plain, solve=ll.lane_lu_solve_plain)


def _system(k, m, B=16, seed=0):
    """Well-conditioned float64 systems: a random matrix plus k on its
    diagonal, and m right-hand sides."""
    rng = np.random.default_rng(seed + 100 * k + m)
    A = rng.standard_normal((B, k, k)) + k * np.eye(k)
    return A, rng.standard_normal((B, k, m))


def _twin_solve(A, b):
    LU, perm, info = ll.lane_lu_factor_plain(A)
    return ll.lane_lu_solve_plain(LU, perm, b), LU, perm, info


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("k", [5, 12, 77, 153])
def test_lu_twin_matches_jax_and_lapack(k, m):
    A, b = _system(k, m, B=4)
    x, _, _, info = _twin_solve(torch.as_tensor(A), torch.as_tensor(b))
    assert not info.any()
    jx = np.asarray(jax.jit(jax.vmap(jax_solve_small))(A, b))
    lx = torch.linalg.solve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-10, atol=0)
    np.testing.assert_allclose(x.numpy(), lx, rtol=1e-10, atol=0)


@pytest.mark.parametrize("k,m", [(5, 1), (12, 3), (77, 2), (153, 1)])
def test_lu_twin_width_invariant(k, m):
    A, b = (torch.as_tensor(t) for t in _system(k, m, seed=1))
    full = _twin_solve(A, b)
    for w in WIDTHS:
        part = _twin_solve(A[:w], b[:w])
        for got, want in zip(part, full):
            assert torch.equal(got, want[:w]), w


@pytest.mark.parametrize("p,q,m", [(12, 12, 1), (77, 77, 2), (1, 153, 3)])
def test_matmul_twin_matches_blas_and_is_width_invariant(p, q, m):
    rng = np.random.default_rng(p + q + m)
    a = torch.as_tensor(rng.standard_normal((16, p, q)))
    b = torch.as_tensor(rng.standard_normal((16, q, m)))
    s = ll.lane_matmul_plain(a, b)
    ref = a @ b
    assert float((s - ref).abs().max()) <= 1e-13 * float(
        (a.abs() @ b.abs()).max())
    for w in WIDTHS:
        assert torch.equal(ll.lane_matmul_plain(a[:w], b[:w]), s[:w]), w
    # a broadcast batch axis and a transposed operand, as callers pass them
    assert torch.equal(ll.lane_matmul_plain(a, b[0]), ll.lane_matmul_plain(a, b[:1].expand_as(b)))
    at = a.transpose(-1, -2)
    assert torch.equal(ll.lane_matmul_plain(at, a), ll.lane_matmul_plain(at.contiguous(), a))


def test_singular_lane_gives_nan_and_neighbours_solve():
    A, b = (torch.as_tensor(t) for t in _system(12, 2, B=5, seed=2))
    A[2, :, 4] = 0.0
    x = ll.lu_solve_nan(A, b, **TWINS)
    _, _, _, info = _twin_solve(A, b)
    assert info.tolist() == [0, 0, 5, 0, 0]
    assert torch.isnan(x[2]).all() and torch.isfinite(x[[0, 1, 3, 4]]).all()
    np.testing.assert_allclose(x[[0, 1, 3, 4]].numpy(),
                               torch.linalg.solve(A[[0, 1, 3, 4]], b[[0, 1, 3, 4]]).numpy(),
                               rtol=1e-10)
    # the vector form, as solve_small takes it
    xv = ll.lu_solve_nan(A, b[..., 0], **TWINS)
    assert torch.equal(xv.nan_to_num(7.0), x[..., 0].nan_to_num(7.0))


def _no_twins():
    """Make the lane kernels' twins and wrappers fail if a CPU run reaches
    them."""
    fail = lambda *a, **k: pytest.fail("a CPU run reached the lane kernels' path")
    return [unittest.mock.patch.object(ll, name, fail) for name in (
        "lane_lu_factor_cuda", "lane_lu_solve_cuda", "lu_solve_nan", "lane_matmul_cuda",
        "lane_lu_factor_plain", "lane_matmul_plain")]


@pytest.mark.parametrize("dtype,k", [(torch.float64, 12), (torch.float64, 30),
                                     (torch.float32, 600)])
def test_cpu_solve_small_keeps_lapack(dtype, k):
    A, b = (torch.as_tensor(t, dtype=dtype) for t in _system(k, 2, B=3, seed=3))
    A[1] = 0.0
    patches = _no_twins()
    for p in patches:
        p.start()
    try:
        x = batched_linalg.solve_small(A, b)
        xv = batched_linalg.solve_small(A, b[..., 0])
    finally:
        for p in patches:
            p.stop()
    for got, rhs in ((x, b), (xv[..., None], b[..., :1])):
        want, info = torch.linalg.solve_ex(A, rhs)
        want = torch.where((info != 0)[:, None, None], torch.full_like(want, float("nan")),
                           want)
        assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
        assert torch.isnan(got[1]).all()


def test_cpu_polish_and_lane_matmul_keep_the_library():
    """float64 on the CPU: ``_polish`` factors once with ``lu_factor_ex``
    and solves with ``lu_solve`` four times (the first solve and three
    refinements), and ``lane_matmul`` is ``a @ b``, to the bit."""
    from chip_smoke import random_qps

    P, q, A, lo, hi = (torch.as_tensor(t) for t in random_qps(6, 21, 42, 0))
    z = torch.as_tensor(np.random.default_rng(4).standard_normal(q.shape))
    y = torch.as_tensor(np.random.default_rng(5).standard_normal(lo.shape))
    spies = {name: unittest.mock.patch.object(
        torch.linalg, name, wraps=getattr(torch.linalg, name)) for name in
        ("lu_factor_ex", "lu_solve")}
    patches = _no_twins()
    for p in patches:
        p.start()
    try:
        with spies["lu_factor_ex"] as factor, spies["lu_solve"] as solve:
            _polish(P, q, A, lo, hi, z, y)
        a, b = P, q[..., None]
        got = batched_linalg.lane_matmul(a, b)
        got_v = batched_linalg.lane_matvec(A, z)
    finally:
        for p in patches:
            p.stop()
    assert factor.call_count == 1 and solve.call_count == 4
    assert torch.equal(got, a @ b)
    assert torch.equal(got_v, (A @ z[..., None])[..., 0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_lane_sum_and_contract_keep_torch(dtype):
    """On the CPU ``lane_sum`` is ``sum`` over a lane's axes and
    ``lane_contract`` the einsum Taylor's fd fit made before, to the bit;
    neither reaches K7."""
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((5, 9, 9)), dtype=dtype)
    Y = torch.as_tensor(rng.standard_normal((5, 7, 2)), dtype=dtype)
    G = torch.as_tensor(rng.standard_normal((3, 7)), dtype=dtype)
    Hc = torch.as_tensor(rng.standard_normal((3, 3, 7)), dtype=dtype)
    patches = _no_twins()
    for p in patches:
        p.start()
    try:
        got = (batched_linalg.lane_sum(x), batched_linalg.lane_contract(G, Y),
               batched_linalg.lane_contract(Hc, Y))
    finally:
        for p in patches:
            p.stop()
    assert torch.equal(got[0], x.sum((-1, -2)))
    assert torch.equal(got[1], torch.einsum("is,bsm->bmi", G, Y))
    assert torch.equal(got[2], torch.einsum("ijs,bsm->bmij", Hc, Y))


@pytest.mark.parametrize("itemsize,last_shared", [(8, 169), (4, 239)])
def test_plans_take_every_size(itemsize, last_shared):
    """K6's plans exist at every k (and m), fit a block's shared memory,
    keep the lane in shared memory exactly up to the largest k whose odd-
    strided copy fits, and raise only on a bad argument."""
    from morbit_tpu_torch.ops import cuda_build

    for k in list(range(1, 300)) + [600, 1377, 5000]:
        f = ll.lu_factor_plan(k, itemsize)
        assert f.smem_bytes <= cuda_build.SMEM_LIMIT and f.lanes_per_block == 1
        assert f.instance == ("shared" if k <= last_shared else "global"), k
        for m in (1, 2, 3, 64):
            s = ll.lu_solve_plan(k, m, itemsize)
            assert s.smem_bytes <= cuda_build.SMEM_LIMIT
            assert (s.instance == "shared") == (k * m * itemsize <= cuda_build.SMEM_LIMIT)
    for bad in ((0, itemsize), (-3, itemsize)):
        with pytest.raises(ValueError):
            ll.lu_factor_plan(*bad)
    with pytest.raises(ValueError):
        ll.lu_solve_plan(5, 0, itemsize)


@pytest.mark.parametrize("a_shape,b_shape", [((4, 3, 5), (4, 5, 2)), ((4, 0, 2), (4, 2, 1)),
                                             ((0, 3, 3), (0, 3, 1)), ((4, 2, 3), (3, 1)),
                                             ((2, 1, 3, 3), (5, 3, 2)), ((4, 3, 0), (4, 0, 2))])
def test_flatten_lanes_and_empty_products(a_shape, b_shape):
    """The kernels' wrappers flatten broadcast batch axes (``flatten_lanes``)
    at every shape ``a @ b`` takes, empty ones included (a constraint-free
    problem's (B, 0, n) rows), and the twin's product equals ``a @ b`` there."""
    rng = np.random.default_rng(7)
    a = torch.as_tensor(rng.standard_normal(a_shape))
    b = torch.as_tensor(rng.standard_normal(b_shape))
    a3, b3, lead = ll.flatten_lanes(a, b)
    assert a3.is_contiguous() and a3.shape[1:] == a.shape[-2:] and b3.shape[1:] == b.shape[-2:]
    assert a3.shape[0] == b3.shape[0] == int(np.prod(lead))
    want = a @ b
    got = ll.lane_matmul_plain(a, b)
    assert got.shape == want.shape
    scale = (a.abs() @ b.abs()).numpy().max(initial=1.0)
    assert np.abs((got - want).numpy()).max(initial=0.0) <= 1e-13 * scale
