"""The port's Taylor surrogates against the JAX package and the oracles.

At float64 on the CPU:

* the flat finite-difference stencils (``_build_stencil``) equal JAX's for
  every first-order stamp, degree and Hessian stamp at n = 2 and 3, and
  reproduce the derivatives of quadratics;
* callback mode's fitted gradients and Hessians (a ``hess=`` callback and
  autodiff) against JAX's on the same start, within 1e-12;
* ``optimize`` on the oracle configs ``taylor-fd1`` and ``taylor-fd2`` (at
  1e-9) and on the Taylor golden trajectory;
* every outer trip of an fd run carried over from JAX's states;
* a B=4 batch against the port's four single runs and the staged runner
  against the plain one, in both modes.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.core.algorithm as jalg
import morbit_tpu.models.taylor as jtay
import morbit_tpu_torch as mt
import morbit_tpu_torch.models.taylor as ttay
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu.core.mop import MOP as JaxMOP
from morbit_tpu.core.mop import compile_mop as jax_compile_mop
from morbit_tpu.models.configs import TaylorConfig as JaxTaylor
from morbit_tpu.utils.parity import compare_trajectories
from morbit_tpu_torch.core.algorithm import Solver
from morbit_tpu_torch.core.mop import compile_mop
from morbit_tpu_torch.models.configs import TaylorConfig
from morbit_tpu_torch.utils.carry import config_from_dict, state_from_numpy, state_to_numpy
from morbit_tpu_torch.utils.parity import export_trajectory
from tests.torch_families import (F64, GOLDEN_X0, LB2, UB2, X0,
                                  assert_batch_equals_singles_and_staged,
                                  assert_matches_oracle, oracle_groups, parabolas)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("stamp", sorted(jtay.STAMPS))
def test_stencil_matches_jax(stamp, n):
    """O, G and H equal the JAX package's exactly for degree 1 and 2 and
    every Hessian stamp; the stamp tables are the port's own copies."""
    for key in jtay.STAMPS:
        for a, b in zip(ttay.STAMPS[key], jtay.STAMPS[key]):
            np.testing.assert_array_equal(a, b)
    for key in jtay.STAMPS2:
        for a, b in zip(ttay.STAMPS2[key], jtay.STAMPS2[key]):
            np.testing.assert_array_equal(a, b)
    for degree in (1, 2):
        for hess in ("compose", "cfd2", "cfd2_4"):
            port = ttay._build_stencil(n, degree, stamp, hess)
            ref = jtay._build_stencil(n, degree, stamp, hess)
            for a, b in zip(port, ref):
                if b is None:
                    assert a is None
                else:
                    np.testing.assert_array_equal(a, b)
            assert TaylorConfig(degree=degree, fd_stamp=stamp, hess_stamp=hess) \
                .resolved_max_points(n) == JaxTaylor(
                    degree=degree, fd_stamp=stamp, hess_stamp=hess).resolved_max_points(n)


def test_fd_gradients_match_truth():
    """``tests/test_models_extra.py::test_taylor_fd_gradients_match_truth``
    on the port's stencil: central differences are exact on a quadratic."""
    O, G, H = ttay._build_stencil(3, 2, "cfd1")
    h = 1e-3
    A = np.array([[2.0, 0.5, 0.0], [0.5, 3.0, 1.0], [0.0, 1.0, 1.5]])
    b = np.array([1.0, -2.0, 0.5])
    x0 = np.array([0.3, -0.2, 0.7])
    vals = np.array([0.5 * s @ A @ s + b @ s for s in x0 + h * O])[:, None]
    np.testing.assert_allclose((G @ vals / h)[:, 0], A @ x0 + b, atol=1e-6)
    np.testing.assert_allclose(np.einsum("ijs,sm->ij", H, vals) / h ** 2, A, atol=1e-4)


def test_direct_second_order_stamp():
    """``tests/test_models_extra.py::test_taylor_direct_second_order_stamp``:
    the direct diagonal stamp has fewer sites and both Hessians are exact
    on a quadratic."""
    n = 3
    O_c, _, H_c = ttay._build_stencil(n, 2, "cfd1", "compose")
    O_d, _, H_d = ttay._build_stencil(n, 2, "cfd1", "cfd2")
    assert O_d.shape[0] < O_c.shape[0]
    rng = np.random.default_rng(0)
    A = rng.normal(size=(n, n))
    A = A + A.T
    b = rng.normal(size=n)
    x0 = rng.normal(size=n)
    f = lambda X: 0.5 * np.einsum("si,ij,sj->s", X, A, X) + X @ b
    for O, H in ((O_c, H_c), (O_d, H_d)):
        np.testing.assert_allclose(np.einsum("ijs,s->ij", H, f(x0 + 1e-3 * O)) / 1e-6, A,
                                   atol=1e-5)


def _curved(port, hess_cb):
    """Two curved objectives in one callback-mode group, the first with a
    Hessian callback when ``hess_cb``."""
    mop, s = (mt.MOP(LB2, UB2), torch) if port else (JaxMOP(LB2, UB2), jnp)
    cfg = (TaylorConfig if port else JaxTaylor)(degree=2, mode="callback")
    f1 = lambda x: s.sum((x - 1.0) ** 2) + 0.3 * s.sin(x[0] * x[1])

    def h1(x):
        c, sn = s.cos(x[0] * x[1]), s.sin(x[0] * x[1])
        H = s.stack([s.stack([-0.3 * x[1] ** 2 * sn, 0.3 * (c - x[0] * x[1] * sn)]),
                     s.stack([0.3 * (c - x[0] * x[1] * sn), -0.3 * x[0] ** 2 * sn])])
        return (2.0 * s.eye(2, dtype=x.dtype) + H)[None]
    mop.add_objective(f1, model_cfg=cfg, hess=h1 if hess_cb else None)
    mop.add_objective(lambda x: s.exp(0.2 * x[0]) + x[1] ** 2 * x[0] / 4.0, model_cfg=cfg)
    return mop


@pytest.mark.parametrize("hess_cb", [True, False], ids=["hess-callback", "autodiff"])
def test_callback_fit_matches_jax(hess_cb):
    """Callback mode's gradients and Hessians, pulled back by the unscaling,
    against JAX's ``TaylorOps.fit`` at the same start (JAX's initial
    state carried over), within 1e-12; the Hessian callback equals
    autodiff there."""
    jsolver = jalg.Solver(jax_compile_mop(_curved(False, hess_cb)), JaxConfig(), jnp.float64)
    jst = jax.jit(jsolver.initialize)(jnp.asarray([0.7, -1.3]))
    solver = Solver(compile_mop(_curved(True, hess_cb)), mt.AlgorithmConfig(), F64, "cpu")
    st = state_from_numpy(_leaves(jst), device="cpu")
    ops, g = solver.container.ops[0], st.groups[0]
    model = ops.fit(ops.init_state(1, "cpu"), g.db, solver.container._contexts(
        st.groups, st.x_s, st.x_indices, st.delta, st.scal)[0])
    ref = jst.groups[0].model
    for name in ("x0", "fx0", "g", "H"):
        np.testing.assert_allclose(getattr(model, name)[0].numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    cb = compile_mop(_curved(True, True)).groups[0].hess_unscaled(torch.tensor([[0.7, -1.3]], dtype=F64))
    ad = compile_mop(_curved(True, False)).groups[0].hess_unscaled(torch.tensor([[0.7, -1.3]], dtype=F64))
    np.testing.assert_allclose(cb.numpy(), ad.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("degree,max_iter", [(1, 12), (2, 8)], ids=["taylor-fd1", "taylor-fd2"])
def test_optimize_matches_full_oracle(degree, max_iter):
    assert_matches_oracle(TaylorConfig(degree=degree, mode="fd"),
                          oracle_groups("taylor", taylor_degree=degree), 1e-9,
                          max_iter=max_iter)


def test_trajectory_matches_taylor_golden():
    res = mt.optimize(parabolas(TaylorConfig(degree=2, mode="fd")), GOLDEN_X0, max_iter=15,
                      device="cpu", dtype=F64)
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "two_parabolas_taylor_fd2_f64.json")) as f:
        golden = json.load(f)
    rep = compare_trajectories(export_trajectory(res), golden, x_tol=1e-10)
    assert rep["parity"], rep


def _leaves(st):
    """A JAX state as the dict of numpy leaves ``utils/carry.py`` takes."""
    out = {f: np.asarray(getattr(st, f))
           for f in ("x", "x_s", "fx", "l_e", "l_i", "c_e", "c_i", "dlt", "ints")}
    out["traj.data"] = np.asarray(st.traj.data)
    out["traj.count"] = np.asarray(st.traj.count)
    for f in ("scale", "offset", "lb_scaled", "ub_scaled"):
        out[f"scal.{f}"] = np.asarray(getattr(st.scal, f))
    for f in ("theta", "fvals", "count", "overflow"):
        out[f"filter.{f}"] = np.asarray(getattr(st.filter, f))
    for i, g in enumerate(st.groups):
        for f in ("data", "count", "overflow"):
            out[f"groups.{i}.db.{f}"] = np.asarray(getattr(g.db, f))
        out[f"groups.{i}.n_evals"] = np.asarray(g.n_evals)
        for f in g.model._fields:
            out[f"groups.{i}.model.{f}"] = np.asarray(getattr(g.model, f))
    return out


def test_iterate_from_carried_jax_taylor_state():
    """Every outer trip of an fd run into the criticality routine: the
    port's ``iterate`` from the carried JAX state equals JAX's next state,
    leaf by leaf (integers exact, floats within 1e-9)."""
    jac = JaxConfig(max_iter=12, f_tol_rel=0.0, x_tol_rel=0.0)
    jsolver = jalg.Solver(jax_compile_mop(parabolas(JaxTaylor(degree=2), port=False)), jac,
                          jnp.float64)
    jiter = jax.jit(jsolver.iterate)
    solver = Solver(compile_mop(parabolas(TaylorConfig(degree=2))),
                    config_from_dict(dataclasses.asdict(jac)), F64, "cpu")
    st = jax.jit(jsolver.initialize)(jnp.asarray(X0))
    trips = 0
    while int(st.stop_code) == 1:
        nxt = jiter(st)
        port = state_to_numpy(solver.iterate(state_from_numpy(_leaves(st), device="cpu")))
        ref = _leaves(nxt)
        assert set(port) == set(ref)
        for name, a in port.items():
            b = ref[name][None]
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=f"trip {trips}: {name}")
            else:
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9,
                                           err_msg=f"trip {trips}: {name}")
        st, trips = nxt, trips + 1
    assert trips > 12


@pytest.mark.parametrize("cfg", [TaylorConfig(degree=2, mode="fd"),
                                 TaylorConfig(degree=1, mode="fd", fd_stamp="ffd1"),
                                 TaylorConfig(degree=2, mode="callback")],
                         ids=["fd2", "fd1-ffd1", "callback"])
def test_batch_equals_singles_and_staged(cfg):
    res = assert_batch_equals_singles_and_staged(cfg, mt.AlgorithmConfig(max_iter=8))
    assert torch.isfinite(res.x).all()
    # a stencil per move fits in the capacity the Taylor term sizes
    assert not bool(res.state.groups[0].db.overflow.any())
