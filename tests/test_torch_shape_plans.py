"""The launch plans of the kernels K1-K4 at every shape, and the port against
the JAX package at a shape past the kernels' former limits, on the CPU.

* every wrapper's plan (``qp_lane.admm_plan``, ``prepare_fused.selection_plan``,
  ``prepare_fused.round4_plan``, ``dense_kernels.gram_plan``) over n = 1..128
  at k = 2 and 3 objectives and 0-4 constraint rows, float32 and float64:
  the plan exists, its block fits the card's shared memory
  (``cuda_build.SMEM_LIMIT``) and it sizes its workspace;
* at every shape the kernels took before they took every shape, the plan is
  the one they had: the same instance, lanes per block and shared memory
  (the formulas below are the ones the wrappers had);
* exact-model ZDT1 at n = 33 (the descent LP at nv = 34, m = 68, past the
  warp instance of K1) at float64, B = 2, ``max_iter=3``: the port on the
  CPU against the JAX package, integers exact, floats within 1e-10;
* ``eval_rbf`` in slices of query sites (the n = 50 path's memory) equal
  to the whole computation to the bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.parallel.multistart as jms
import morbit_tpu.problems.synthetic as jsyn
import morbit_tpu_torch as mt
import morbit_tpu_torch.problems.synthetic as tsyn
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu_torch.ops import cuda_build, dense_kernels, prepare_fused, qp_lane
from morbit_tpu_torch.utils.logging import trajectory_arrays

ITEMSIZES = (4, 8)


def _lp_shapes(n, k, c):
    """(nv, m) of the solver's LPs at n variables, k objectives and c
    constraint rows: the descent LP (``core/descent.py: descent_lp``) and
    the normal-step LP (``normal_lp``)."""
    return ((n + 1, k + 2 * n + c), (n + 2, 3 * n + 3 + c))


def _check(plan):
    assert plan.lanes_per_block >= 1
    assert 0 <= plan.smem_bytes <= cuda_build.SMEM_LIMIT
    assert plan.work_elems >= 0


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_every_shape_has_a_plan(itemsize):
    """n = 1..128, k in {2, 3}, 0-4 constraint rows: every kernel's plan
    exists and fits a block's shared memory; where a lane's state does not
    fit there, the plan names a workspace."""
    for n in range(1, 129):
        for k in (2, 3):
            for c in range(5):
                for nv, m in _lp_shapes(n, k, c):
                    plan = qp_lane.admm_plan(nv, m, itemsize)
                    _check(plan)
                    if plan.instance == "strided" and plan.place:
                        assert plan.work_elems >= 2 * nv * (nv | 1)
        _check(prepare_fused.selection_plan(n, itemsize))
        max_points = (n + 1) * (n + 2) // 2
        for maxN, pd in ((max_points, n + 1), (max_points, 1), (600, n + 1),
                         (max(1, n // 2), n + 1)):
            plan = prepare_fused.round4_plan(maxN, n, pd, itemsize)
            _check(plan)
            if plan.instance != "thread":
                ld = max(maxN, pd)
                assert plan.work_elems >= ld * (n + 2 * pd) + 5 * ld * ld
        for P in (n + 1, max_points, max_points + n + 1):
            _check(dense_kernels.gram_plan(P, n, itemsize))


def _old_admm(nv, m, item):
    if (nv, m) in ((3, 6), (4, 8)):
        return ("register", 128, 0)
    ld = nv | 1
    return ("warp", 4, 4 * ((m + 3 * nv) * ld + 3 * m + 3 * nv) * item)


def _old_selection(n, item):
    if n in (2, 3):
        return ("register", 128, 0)
    vec = 16 // item
    ld = -(-n // vec) * vec
    rows = 24 * 1024 // (ld * item)
    elems = (3 * n + rows + 7) * ld + 2 * n * (n | 1) + 4
    return ("block", 1, elems * item + (3 * 32 + 8) * 4)


def _old_round4(maxN, n, pd, item):
    if maxN <= 24 and pd <= 16 and n <= 15:
        return ("thread", 128, 0, 0)
    return ("block", 1, item * (8 * maxN + 2 * pd * pd + 5 * pd),
            maxN * (n + 2 * pd) + 5 * maxN * maxN)


def _old_gram(P, n, item):
    rows = -(-P // 32) * 32
    ld = -(-n // 4) * 4
    ld += 4 if (ld // 4) % 2 == 0 else 0
    return ("staged", 1, item * (rows * ld + rows + 8 * 32 * 33) + rows)


@pytest.mark.parametrize("kernel", ["admm", "selection", "round4", "gram"])
@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_plans_inside_the_former_limits_are_unchanged(kernel, itemsize):
    """At every shape a kernel took before (K1: nv <= 32, m <= 64; K2:
    n <= 32; K3: max_points <= 512, n <= 32, pd <= max_points; K4: the
    lane's sites in a block's shared memory) its plan is the former one:
    the same instance, lanes per block and shared-memory bytes (and K3's
    lane of workspace), so those launches and their bits do not change."""
    key = lambda p: (p.instance, p.lanes_per_block, p.smem_bytes)
    if kernel == "admm":
        for nv in range(1, 33):
            for m in range(1, 65):
                assert key(qp_lane.admm_plan(nv, m, itemsize)) == _old_admm(nv, m, itemsize)
    elif kernel == "selection":
        for n in range(1, 33):
            plan = prepare_fused.selection_plan(n, itemsize)
            assert key(plan) == _old_selection(n, itemsize)
            assert plan.stage_rows == prepare_fused.selection_stage_rows(n, itemsize)
    elif kernel == "round4":
        for n in range(1, 33):
            for pd in sorted({0, 1, n + 1}):
                for maxN in range(max(1, pd), 513, 7):
                    plan = prepare_fused.round4_plan(maxN, n, pd, itemsize)
                    assert key(plan) + (plan.work_elems,) == _old_round4(maxN, n, pd, itemsize)
    else:
        for n in range(1, 33):
            for P in range(1, 1400, 13):
                old = _old_gram(P, n, itemsize)
                if old[2] <= cuda_build.SMEM_LIMIT:
                    assert key(dense_kernels.gram_plan(P, n, itemsize)) == old
                else:
                    assert dense_kernels.gram_plan(P, n, itemsize).instance == "tiled"


def test_exact_zdt1_n33_matches_jax():
    """Exact-model ZDT1 at n = 33 (K1's descent LP at nv = 34, m = 68, past
    its warp instance), float64, B = 2, ``max_iter=3``: the port against the
    JAX package lane by lane, integers exact (stop code, iterations,
    evaluations, iteration types, trajectory indices), iterates and values
    within 1e-10."""
    n, B, kw = 33, 2, dict(max_iter=3)
    lb, ub = jsyn.zdt_bounds("zdt1", n)
    starts = tsyn.halton_starts(B, lb, ub, 1)
    port = mt.multistart_optimize(tsyn.make_zdt("zdt1", n), starts,
                                  mt.AlgorithmConfig(**kw), dtype=torch.float64,
                                  device="cpu")
    ref = jms.multistart_optimize(jsyn.make_zdt("zdt1", n), jnp.asarray(starts),
                                  JaxConfig(**kw), dtype=jnp.float64)
    for i in range(B):
        tp = trajectory_arrays(port, i)
        traj = ref.state.traj
        c = int(traj.count[i])
        assert int(port.stop_code[i]) == int(ref.stop_code[i])
        assert int(port.n_iterations[i]) == int(ref.n_iterations[i])
        assert ([int(g.n_evals[i]) for g in port.state.groups]
                == [int(g.n_evals[i]) for g in ref.state.groups])
        assert tp["it_stat"].tolist() == np.asarray(traj.it_stat[i][:c]).tolist()
        np.testing.assert_array_equal(tp["x_indices"], np.asarray(traj.x_indices[i][:c]))
        for name in ("x", "fx"):
            np.testing.assert_allclose(tp[name], np.asarray(getattr(traj, name)[i][:c]),
                                       rtol=0, atol=1e-10)
        np.testing.assert_allclose(port.x[i].numpy(), np.asarray(ref.x[i]), rtol=0,
                                   atol=1e-10)


def test_eval_rbf_in_slices_matches_whole(monkeypatch):
    """``eval_rbf`` forms the (B, K, P, n) differences a slice of query
    sites at a time past ``EVAL_CHUNK_ELEMS`` (the n = 50 path's
    backtracking ladder): the values equal the whole computation's to the
    bit."""
    from morbit_tpu_torch.ops import rbf as trbf

    rng = np.random.default_rng(3)
    B, P, n, K = 3, 17, 5, 11
    sites = torch.as_tensor(rng.uniform(size=(B, P, n)))
    mask = torch.as_tensor(rng.uniform(size=(B, P)) < 0.8)
    fit = trbf.RbfFit(sites=sites, mask=mask, w=torch.as_tensor(rng.normal(size=(B, P, 2))),
                      lam=torch.as_tensor(rng.normal(size=(B, n + 1, 2))),
                      param=torch.ones(B, dtype=torch.float64))
    X = torch.as_tensor(rng.uniform(size=(B, K, n)))
    whole = trbf.eval_rbf(fit, X, "cubic", 1)
    monkeypatch.setattr(trbf, "EVAL_CHUNK_ELEMS", 2 * B * P * n)
    assert torch.equal(trbf.eval_rbf(fit, X, "cubic", 1), whole)
