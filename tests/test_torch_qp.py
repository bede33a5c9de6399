"""The port's batched QP solver and its ADMM kernel against the JAX package.

* float64: the port's ``solve_qp`` (plain twin of the stage loop on the CPU)
  against ``jax.vmap(morbit_tpu.ops.qp.solve_qp)`` on random LPs/QPs and on
  the steepest-descent LPs of two parabolas at Halton starts;
* float32: the twin against the JAX Pallas kernel run in interpreter mode,
  as ``tests/test_qp_lane.py`` runs it, at that file's tolerances.

The CUDA kernel itself is held against the twin on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.ops.qp_lane as jqpl
from chip_smoke import random_qps
from morbit_tpu.core.descent import LinearizedConstraints
from morbit_tpu.core.descent import steepest_descent_direction as jax_sdd
from morbit_tpu.ops.qp import solve_qp as jax_solve_qp
from morbit_tpu.problems.synthetic import halton_starts
from morbit_tpu_torch.core.descent import steepest_descent_direction
from morbit_tpu_torch.ops import qp_lane
from morbit_tpu_torch.ops.qp import _rho_vec, solve_qp


def _problems(B, n, m, seed=0):
    """Tiny feasible bounded QPs in OSQP form (the ``tests/test_qp_lane.py``
    pattern), shared with ``chip_smoke.py``."""
    return random_qps(B, n, m, seed)


def _lps(B, n, m, seed=0):
    """Same rows with P = 0: linear programs, the solver's case."""
    P, q, A, lo, hi = _problems(B, n, m, seed)
    return np.zeros_like(P), q, A, lo, hi


def _compare(port, ref, tol):
    ok = np.asarray(ref.status_ok)
    np.testing.assert_array_equal(port.status_ok.numpy(), ok)
    for name in ("z", "y", "obj"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("make,n,m,seed", [(_problems, 3, 6, 0),
                                           (_lps, 3, 6, 1),
                                           (_problems, 4, 8, 2)])
def test_solve_qp_f64_matches_jax(make, n, m, seed):
    args = make(16, n, m, seed)
    ref = jax.jit(jax.vmap(jax_solve_qp))(*(jnp.asarray(a) for a in args))
    port = solve_qp(*(torch.as_tensor(a) for a in args))
    _compare(port, ref, 1e-10)


def _descent_inputs(B):
    """Two-parabolas descent LP data at Halton starts, in unit-cube scaling."""
    lb, ub = np.full(2, -4.0), np.full(2, 4.0)
    x = halton_starts(B, lb, ub, start_index=3)
    x_s = (x - lb) / (ub - lb)
    Dm = np.stack([2.0 * (x - 1.0), 2.0 * (x + 1.0)], axis=1) * (ub - lb)
    return x_s, Dm, np.zeros_like(x_s), np.ones_like(x_s)


def test_descent_lp_f64_matches_jax():
    x_s, Dm, lb, ub = _descent_inputs(16)
    empty = LinearizedConstraints(jnp.zeros((0, 2)), jnp.zeros((0,)),
                                  jnp.zeros((0, 2)), jnp.zeros((0,)))
    d_j, om_j = jax.jit(jax.vmap(lambda *a: jax_sdd(*a, empty)))(x_s, Dm, lb, ub)
    d_p, om_p = steepest_descent_direction(*(torch.as_tensor(a) for a in
                                             (x_s, Dm, lb, ub)))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(om_p.numpy(), np.asarray(om_j), rtol=0, atol=1e-10)
    assert np.all(np.isfinite(om_p.numpy()))


@pytest.mark.parametrize("B,n,m", [(8, 3, 6), (4, 2, 4)])
def test_twin_f32_matches_jax_pallas_kernel(monkeypatch, B, n, m):
    monkeypatch.setattr(jqpl, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jqpl, "_MIN_B", 1)
    args = [a.astype(np.float32) for a in _problems(B, n, m)]

    def solve(*a):
        return jax_solve_qp(*a, iters=200, adapt_every=50)

    ref = jax.jit(jax.vmap(solve))(*(jnp.asarray(a) for a in args))
    port = solve_qp(*(torch.as_tensor(a) for a in args), iters=200,
                    adapt_every=50)
    # unconverged lanes amplify rounding order (tests/test_qp_lane.py)
    ok = np.asarray(ref.status_ok)
    np.testing.assert_array_equal(port.status_ok.numpy(), ok)
    np.testing.assert_allclose(port.z.numpy()[ok], np.asarray(ref.z)[ok],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(port.obj.numpy()[ok], np.asarray(ref.obj)[ok],
                               rtol=2e-3, atol=2e-3)


def test_cpu_tensors_never_launch_the_kernel(monkeypatch):
    monkeypatch.setattr(qp_lane, "launches", 0)
    args = [torch.as_tensor(a) for a in _lps(4, 3, 6)]
    solve_qp(*args, iters=20, adapt_every=10)
    solve_qp(*(a.float() for a in args), iters=20, adapt_every=10)
    assert qp_lane.launches == 0


def test_kernel_refuses_wide_problems():
    """K1 takes every shape: past its warp instance (nv = 33) the wrapper
    plans the strided instance and refuses only the CPU tensors it was
    given, never the size."""
    P, q, A, lo, hi = (torch.as_tensor(a) for a in _lps(2, 33, 36))
    assert qp_lane.admm_plan(33, 36, 8).instance == "strided"
    with pytest.raises(ValueError, match="cuda"):
        qp_lane.admm_stages_cuda(P, q, A, lo, hi, _rho_vec(lo, hi, 0.1),
                                 n_stages=1, n_steps=1, sigma=1e-6,
                                 alpha=1.6, rho_lo=1e-6, rho_hi=1e6)
