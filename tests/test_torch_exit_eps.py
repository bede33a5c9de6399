"""The QP's residual early exit (``AlgorithmConfig.qp_exit_eps``) in the port
against the JAX package.

The JAX package stops a QP's rho-stage loop once both residuals after a
stage are at most ``exit_eps`` (``morbit_tpu/ops/qp.py:216-238``); under
``vmap`` that stop is per lane. The port runs it per lane in the plain twin
``qp_lane.admm_stages_exit_plain`` (the CUDA kernel's exit instance is held
against it on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``):

* ``solve_qp(exit_eps=1e-5)`` against JAX's on ``tests/test_qp.py``'s six
  instances, and within 5e-5 of the fixed-trip path, as there;
* a batch whose lanes stop at different stages equals each lane solved
  alone: stage counts exact, z to the bit;
* ``exit_eps=0`` is the fixed-trip path, to the bit;
* ``optimize(qp_exit_eps=1e-6)`` against JAX's run: integers exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.problems.synthetic as jsyn
import morbit_tpu_torch.problems.synthetic as tsyn
from chip_smoke import random_qps
from morbit_tpu.core.algorithm import optimize as jax_optimize
from morbit_tpu.models.configs import RbfConfig as JaxRbfConfig
from morbit_tpu.ops.qp import solve_qp as jax_solve_qp
from morbit_tpu_torch import optimize
from morbit_tpu_torch.models.configs import RbfConfig
from morbit_tpu_torch.ops import qp_lane
from morbit_tpu_torch.ops.qp import _rho_vec, solve_qp

LB, UB = np.full(2, -4.0), np.full(2, 4.0)


def _test_qp_instances():
    """The six instances of ``tests/test_qp.py::test_f32_early_exit_matches_fixed_budget``."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(6):
        n, m = 5, 7
        G = rng.normal(size=(n, n))
        P = G @ G.T + 0.5 * np.eye(n)
        q = rng.normal(size=n)
        A = rng.normal(size=(m, n))
        l = np.full(m, -np.inf)
        u = rng.uniform(0.5, 2.0, size=m)
        out.append((P, q, A, l, u))
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solve_qp_exit_matches_jax(dtype):
    tol = {"float32": 2e-7, "float64": 1e-14}[dtype]
    for args in _test_qp_instances():
        args = [a.astype(dtype) for a in args]
        ref = jax_solve_qp(*(jnp.asarray(a) for a in args), iters=400, exit_eps=1e-5)
        lane = [torch.as_tensor(a)[None] for a in args]
        fast = solve_qp(*lane, iters=400, exit_eps=1e-5)
        slow = solve_qp(*lane, iters=400)
        np.testing.assert_allclose(fast.z[0].numpy(), np.asarray(ref.z), rtol=0, atol=tol)
        np.testing.assert_allclose(fast.z.numpy(), slow.z.numpy(), rtol=0, atol=5e-5)
        assert float(fast.prim_res[0]) < 1e-4


def _stage_args(B, seed, dtype):
    P, q, A, lo, hi = random_qps(B, 3, 6, seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    lo, hi = t(lo), t(hi)
    return (t(np.zeros_like(P)), t(q), t(A), lo, hi, _rho_vec(lo, hi, 0.1))


STAGE_KW = dict(n_stages=4, n_steps=100, sigma=1e-6, alpha=1.6, rho_lo=1e-6,
                rho_hi=1e6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_exit_batch_equals_single_lanes(dtype):
    """Lanes that stop at different stages: the batch equals each lane
    solved alone, stage counts exact and z, zz, y to the bit."""
    args = _stage_args(24, 3, dtype)
    eps = 1e-6 if dtype == torch.float64 else 1e-4
    z, zz, y, stages = qp_lane.admm_stages_exit_plain(*args, exit_eps=eps, **STAGE_KW)
    assert len(set(stages.tolist())) >= 3, stages   # the lanes really part
    for b in range(args[1].shape[0]):
        one = qp_lane.admm_stages_exit_plain(*(a[b:b + 1] for a in args), exit_eps=eps,
                                             **STAGE_KW)
        assert int(one[3][0]) == int(stages[b])
        for got, want in zip(one[:3], (z, zz, y)):
            assert torch.equal(got[0], want[b])


def test_exit_twin_runs_the_fixed_stages_until_a_lane_stops():
    """Each lane's exit result equals the fixed-trip loop run for that
    lane's stage count, to the bit; and a stage count of the full budget
    gives the fixed-trip result."""
    args = _stage_args(16, 5, torch.float64)
    z, zz, y, stages = qp_lane.admm_stages_exit_plain(*args, exit_eps=1e-6, **STAGE_KW)
    for k in range(1, STAGE_KW["n_stages"] + 1):
        fixed = qp_lane.admm_stages_plain(*args, **{**STAGE_KW, "n_stages": k})
        lanes = stages == k
        for got, want in zip((z, zz, y), fixed):
            assert torch.equal(got[lanes], want[lanes])


def test_exit_eps_zero_is_the_fixed_path():
    args = [torch.as_tensor(a) for a in random_qps(16, 3, 6, 9)]
    ref = solve_qp(*args)
    for eps in (0, 0.0):
        got = solve_qp(*args, exit_eps=eps)
        for f in ref._fields:
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
    # one stage: no exit to take, the fixed path
    one = solve_qp(*args, iters=100, exit_eps=1e-3)
    fixed = solve_qp(*args, iters=100)
    assert torch.equal(one.z, fixed.z)
    with pytest.raises(ValueError, match="exit_eps > 0"):
        qp_lane.admm_stages_exit_cuda(*_stage_args(2, 0, torch.float64), exit_eps=0.0,
                                      **STAGE_KW)


@pytest.mark.parametrize("model,x0", [("exact", (-3.0, 2.5)), ("exact", (1.5, -3.2)),
                                      ("rbf", (-3.0, 2.5)), ("rbf", (1.5, -3.2))])
def test_optimize_with_qp_exit_matches_jax(model, x0):
    """``optimize(qp_exit_eps=1e-6)`` on two parabolas: stop code,
    iterations, evaluations and the iteration types exact, iterates within
    1e-10."""
    jcfg, tcfg = ((None, None) if model == "exact"
                  else (JaxRbfConfig(kernel="multiquadric"), RbfConfig(kernel="multiquadric")))
    ref = jax_optimize(jsyn.make_two_parabolas(jcfg, LB, UB), jnp.asarray(x0),
                       max_iter=20, qp_exit_eps=1e-6, dtype=jnp.float64)
    res = optimize(tsyn.make_two_parabolas(tcfg, LB, UB), x0, max_iter=20,
                   qp_exit_eps=1e-6, device="cpu")
    for f in ("stop_code", "n_iterations", "n_evals"):
        assert int(getattr(res, f)) == int(getattr(ref, f)), f
    k = int(ref.state.traj.count)
    np.testing.assert_array_equal(res.state.traj.it_stat[:k].numpy(),
                                  np.asarray(ref.state.traj.it_stat)[:k])
    np.testing.assert_allclose(res.state.traj.x[:k].numpy(),
                               np.asarray(ref.state.traj.x)[:k], rtol=0, atol=1e-10)
