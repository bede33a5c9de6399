"""Host (NumPy) black-box functions in the port against the JAX package.

A function registered with ``host=True`` is a plain NumPy callable: the
JAX package bridges it with ``jax.pure_callback``, the port calls it on the
host at the rows of one masked pass (``core/mop.host_pass``). Mirrors
``tests/test_host_eval_parity.py`` and the host cases of
``tests/test_batching.py`` with the port's stronger contract: the port
masks every true evaluation per lane, so on RBF, Lagrange and
finite-difference Taylor groups, in runs without restoration, the rows
passed to the user's function equal its group's evaluation counter, per
lane and in total (the JAX package only bounds them by it). At float64 on
the CPU:

* host problems solved by the JAX package and the port (plain, constrained,
  composite with a host inner function): integers exact, floats within
  1e-10; Taylor callback and exact models, whose derivatives are central
  differences: floats within 1e-8 (XLA contracts the untransform ``x_s *
  scale + offset`` into one fused multiply-add on the CPU, so a difference
  site may lie one ulp away from the port's, and the difference quotient
  divides that by 2 fd_step = 3e-7);
* the finite-difference Jacobian and Hessian against JAX's ``VecFun`` at
  the same ``fd_step`` (1e-12);
* B=8 ``multistart_optimize`` and a tuned ``StagedMultistart`` with host
  objectives equal lane by lane to the same problem in torch functions,
  rows equal to the counters, and compaction sending the same sites;
* ``add_rbf_objective``/``add_lagrange_objective``/``add_taylor_objective``
  against the JAX adders' compiled structure.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.core.algorithm as jalg
import morbit_tpu_torch as mt
import morbit_tpu_torch.problems.synthetic as tsyn
from morbit_tpu.core.mop import MOP as JaxMOP
from morbit_tpu.core.mop import VecFun as JaxVecFun
from morbit_tpu.core.mop import compile_mop as jax_compile_mop
from morbit_tpu.models.configs import ExactConfig as JaxExact
from morbit_tpu.models.configs import LagrangeConfig as JaxLagrange
from morbit_tpu.models.configs import RbfConfig as JaxRbf
from morbit_tpu.models.configs import TaylorConfig as JaxTaylor
from morbit_tpu_torch.core.mop import VecFun, compile_mop
from morbit_tpu_torch.models.configs import (ExactConfig, LagrangeConfig, RbfConfig,
                                             TaylorConfig)
from morbit_tpu_torch.parallel.multistart import (StagedMultistart, build_solver,
                                                  suggest_db_capacity)

F64 = torch.float64
LB, UB = [-4.0, -4.0], [4.0, 4.0]


class Recorder:
    """A NumPy function that records the sites it is called at (the
    reference's counting mock, ``test/test_batching.jl:6-16``)."""

    def __init__(self, fn, batched):
        self.fn, self.batched, self.sites, self.calls = fn, batched, [], 0

    def __call__(self, x):
        x = np.asarray(x)
        self.calls += 1
        self.sites.append(x.reshape((-1, x.shape[-1])).copy())
        return self.fn(x)

    @property
    def rows(self):
        return sum(len(s) for s in self.sites)


def _sq_minus(c):
    return lambda x: np.sum((x - c) ** 2, axis=-1, keepdims=x.ndim > 1)


def _compare_runs(res, ref, tol=1e-10):
    for f in ("stop_code", "n_iterations", "n_evals"):
        assert int(getattr(res, f)) == int(getattr(ref, f)), f
    for a, b in zip(res.state.groups, ref.state.groups):
        assert int(a.n_evals) == int(b.n_evals)
    k = int(ref.state.traj.count)
    np.testing.assert_array_equal(res.state.traj.it_stat[:k].numpy(),
                                  np.asarray(ref.state.traj.it_stat)[:k])
    np.testing.assert_allclose(res.state.traj.x[:k].numpy(), np.asarray(ref.state.traj.x)[:k],
                               rtol=0, atol=tol)
    np.testing.assert_allclose(res.fx.numpy(), np.asarray(ref.fx), rtol=0, atol=tol)


_JAX_RUNS = {}


def _pair(build, x0, tol=1e-10, key=None, **kw):
    """The same problem through JAX's and the port's ``optimize``; ``build``
    takes (MOP, RbfConfig, ExactConfig, numpy module, port) and returns the
    problem and its host recorders. JAX's run is kept under ``key``."""
    if key not in _JAX_RUNS or key is None:
        ref_mop, _ = build(JaxMOP, JaxRbf, JaxExact, jnp, False)
        _JAX_RUNS[key] = jalg.optimize(ref_mop, jnp.asarray(x0), dtype=jnp.float64, **kw)
    ref = _JAX_RUNS[key]
    mop, recs = build(mt.MOP, RbfConfig, ExactConfig, torch, True)
    res = mt.optimize(mop, x0, device="cpu", **kw)
    _compare_runs(res, ref, tol)
    return mop, res, recs


@pytest.mark.parametrize("can_batch", [False, True])
def test_host_objective_calls_match_counter(can_batch):
    """``test_host_objective_calls_match_counter`` and
    ``test_host_can_batch_masked_eval_missing``: a host objective beside a
    torch one in one multiquadric group. The host function is called at
    exactly the counted rows (one call a pass with ``can_batch``, one a row
    without), and the run equals JAX's."""
    def build(MOP, Rbf, Exact, s, port):
        rec = Recorder(_sq_minus(1.0), can_batch)
        mop = MOP(LB, UB)
        mop.add_objective(rec, model_cfg=Rbf(kernel="multiquadric"), host=True,
                          can_batch=can_batch)
        mop.add_objective(lambda x: s.sum((x + 1.0) ** 2), model_cfg=Rbf(kernel="multiquadric"))
        return mop, [rec]

    # JAX's run (one with either can_batch) is made once
    mop, res, (rec,) = _pair(build, [-3.0, 2.5], key="objective", max_iter=8)
    counter = int(res.state.groups[0].n_evals)
    st = mop.functions[0].stats
    assert len(res.state.groups) == 1
    assert rec.rows == st.rows["eval"] == counter and st.rows["fd"] == 0
    assert st.lane_rows.tolist() == [counter]
    if can_batch:   # one call a pass that has rows
        assert 0 < rec.calls == st.calls <= min(st.round_trips, counter)
    else:
        assert rec.calls == st.calls == counter


def test_host_constrained_calls_match_counter():
    """``test_host_constrained_calls_match_counter``: exact objectives and a
    host RBF constraint that is never violated; the candidate at x + n and
    restoration's tail never run, so the constraint is called exactly at
    its counted rows; the run equals JAX's."""
    def build(MOP, Rbf, Exact, s, port):
        rec = Recorder(lambda x: np.atleast_1d(np.sum(x ** 2, axis=-1) - 50.0), False)
        mop = MOP(LB, UB)
        mop.add_exact_objective(lambda x: s.sum((x - 1.0) ** 2))
        mop.add_exact_objective(lambda x: s.sum((x + 1.0) ** 2))
        mop.add_nl_ineq_constraint(rec, model_cfg=Rbf(kernel="cubic"), host=True)
        return mop, [rec]

    mop, res, (rec,) = _pair(build, [-1.5, 1.0], max_iter=6)
    counter = int(res.state.groups[-1].n_evals)
    assert 0 < rec.rows == counter == mop.functions[-1].stats.rows["eval"]


def test_host_objective_runs_and_batches_one_call_a_pass():
    """``tests/test_batching.py``'s host cases: a host RBF objective beside
    an exact torch one runs to a finite point; with and without
    ``can_batch`` the counters agree, the batched function is called once
    a pass with rows and the unbatched once a row, both exactly at the
    counted rows."""
    runs = {}
    for can_batch in (True, False):
        rec = Recorder(lambda x: np.sum(x ** 2, axis=-1, keepdims=x.ndim > 1), can_batch)
        mop = mt.MOP([-2.0, -2.0], [2.0, 2.0])
        mop.add_objective(rec, model_cfg=RbfConfig(kernel="multiquadric"), host=True,
                          can_batch=can_batch)
        mop.add_exact_objective(lambda x: torch.sum((x + 1.0) ** 2))
        res = mt.optimize(mop, [1.5, -1.0], max_iter=4, device="cpu")
        assert torch.isfinite(res.x).all()
        runs[can_batch] = (res, rec)
    (rb, fb), (rs, fs) = runs[True], runs[False]
    assert torch.equal(rb.x, rs.x) and int(rb.n_evals) == int(rs.n_evals)
    counter = int(rb.state.groups[0].n_evals)
    assert fb.rows == fs.rows == fs.calls == counter > fb.calls > 0
    assert all(len(s) > 1 or fb.batched for s in fb.sites)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fd_jacobian_and_hessian_match_jax(dtype):
    """Central differences of a host function (``fd_step``, and
    ``fd_step ** 0.5`` for the Hessian) against JAX's ``VecFun`` at the same
    sites, to 1e-12 relative to the values' scale; a masked Jacobian is
    zero at the unmasked sites and calls the function at the masked ones
    only."""
    # x * x * x, not x ** 3: NumPy's power loops round differently for
    # strided and contiguous arrays, and JAX's callback passes other strides
    fn = lambda x: np.stack([np.sum(x * x * x, axis=-1), np.prod(x, axis=-1) + x[..., 0]], -1)
    X = np.random.default_rng(3).uniform(-1.0, 1.0, (2, 3)).astype(dtype)
    port = VecFun(fn=fn, n_out=2, model_cfg=ExactConfig(), role="objective", host=True)
    ref = JaxVecFun(fn=fn, n_out=2, model_cfg=JaxExact(), role="objective", host=True)
    J = port.jacobian(torch.as_tensor(X)).numpy()
    H = port.hessians(torch.as_tensor(X)).numpy()
    for b in range(X.shape[0]):
        Jr = np.asarray(ref.jacobian(jnp.asarray(X[b])))
        Hr = np.asarray(ref.hessians(jnp.asarray(X[b])))
        np.testing.assert_allclose(J[b], Jr, rtol=0, atol=1e-12 * max(1.0, np.abs(Jr).max()))
        np.testing.assert_allclose(H[b], Hr, rtol=0, atol=1e-12 * max(1.0, np.abs(Hr).max()))
    assert port.stats.rows["fd"] == X.shape[0] * (2 * 3 + 4 * 3 * 3)
    rec = Recorder(fn, True)
    masked = VecFun(fn=rec, n_out=2, model_cfg=ExactConfig(), role="objective", host=True,
                    can_batch=True)
    Jm = masked.jacobian(torch.as_tensor(X), torch.tensor([True, False])).numpy()
    assert rec.rows == 2 * 3 and not Jm[1].any()
    np.testing.assert_array_equal(Jm[0], J[0])


def _composite_build(MOP, Rbf, Exact, s, port):
    rec = Recorder(lambda X: np.stack([np.sum((X - 1.0) ** 2, -1), np.sum((X + 1.0) ** 2, -1)],
                                      -1), True)
    mop = MOP(LB, UB)
    g = mop.add_function(rec, n_out=2, model_cfg=Rbf(kernel="cubic"), host=True,
                         can_batch=True)
    mop.add_composite_objective(lambda x, v: v[0], g)
    mop.add_composite_objective(lambda x, v: v[1] + 0.1 * x[0], g)
    mop.add_composite_nl_ineq_constraint(lambda x, v: v[0] - 9.0, g)
    return mop, [rec]


def test_host_composite_inner_matches_jax():
    """``examples/composites.py``'s problem with its inner function g as a
    batched NumPy host function: the inner values come through the masked
    host pass, the outer functions stay torch (JAX) functions. From a
    feasible start g is called at exactly its counted rows and the run
    equals the port's run with g as a torch function, to the bit. From
    (3.9, -3.9), which violates g0 <= 9, restoration's merit passes and its
    finite-difference Jacobians reach g too (counted apart), and the run
    equals JAX's. Restoration's step halving compares merits whose
    derivatives are finite differences, so other infeasible starts may
    part: (-3.9, 3.9) takes 16 evaluations here against 14 with g as a
    torch function."""
    mop, (rec,) = _composite_build(mt.MOP, RbfConfig, ExactConfig, torch, True)
    res = mt.optimize(mop, [-1.5, 1.0], max_iter=6, device="cpu")
    ref = mt.optimize(tsyn.make_composite(RbfConfig(kernel="cubic"), LB, UB), [-1.5, 1.0],
                      max_iter=6, device="cpu")
    assert torch.equal(res.state.traj.data, ref.state.traj.data)
    st = mop.functions[0].stats
    assert rec.rows == st.rows["eval"] == int(res.state.groups[0].n_evals) > 0
    mop, res, (rec,) = _pair(_composite_build, [3.9, -3.9], tol=1e-8, max_iter=6)
    st = mop.functions[0].stats
    assert st.rows["restoration"] > 0 and st.rows["fd"] > 0
    assert rec.rows == sum(st.rows.values())


@pytest.mark.parametrize("model", ["taylor_callback", "exact"])
def test_host_taylor_callback_and_exact_match_jax(model):
    """A host objective in a Taylor callback group (degree 2: the Jacobian
    and Hessian by central differences at each rebuild) and in an exact
    group (finite-difference Jacobians of the true function), beside a
    torch objective: the runs equal JAX's (floats within 1e-8, see the
    module docstring)."""
    def build(MOP, Rbf, Exact, s, port):
        rec = Recorder(_sq_minus(1.0), False)
        mop = MOP(LB, UB)
        if model == "exact":
            mop.add_exact_objective(rec, host=True)
            mop.add_exact_objective(lambda x: s.sum((x + 1.0) ** 2))
        else:
            cfg = (TaylorConfig if port else JaxTaylor)(degree=2, mode="callback")
            mop.add_objective(rec, model_cfg=cfg, host=True)
            mop.add_objective(lambda x: s.sum((x + 1.0) ** 2), model_cfg=cfg)
        return mop, [rec]

    mop, res, (rec,) = _pair(build, [-3.0, 2.5], tol=1e-8, max_iter=6)
    assert mop.functions[0].stats.rows["fd"] > 0


def _host_parabolas(cfg, batched=True):
    mop = mt.MOP(LB, UB)
    recs = [Recorder(_sq_minus(c), batched) for c in (1.0, -1.0)]
    for r in recs:
        mop.add_objective(r, model_cfg=cfg, host=True, can_batch=batched)
    return mop, recs


@pytest.mark.parametrize("cfg", [RbfConfig(kernel="multiquadric"),
                                 TaylorConfig(degree=2, mode="fd"), LagrangeConfig(degree=2)],
                         ids=["rbf", "taylor_fd", "lagrange"])
def test_multistart_host_equals_torch_lane_by_lane(cfg):
    """B=8 ``multistart_optimize`` with both objectives as NumPy host
    functions in one group: equal lane by lane (to the bit) to the same
    problem in torch functions, and each lane's rows passed to the host
    equal to its group counter."""
    x0 = tsyn.halton_starts(8, LB, UB, 3)
    ac = mt.AlgorithmConfig(max_iter=8)
    mop, recs = _host_parabolas(cfg)
    res = mt.multistart_optimize(mop, x0, ac, F64, "cpu")
    ref = mt.multistart_optimize(tsyn.make_two_parabolas(cfg, LB, UB), x0, ac, F64, "cpu")
    for f in ("x", "fx", "stop_code", "n_iterations", "n_evals"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    counter = res.state.groups[0].n_evals.numpy()
    for f, rec in zip(mop.functions, recs):
        assert f.stats.lane_rows.tolist() == counter.tolist()
        assert rec.rows == counter.sum() == f.stats.rows["eval"]


def test_staged_host_sends_the_plain_runs_sites():
    """A probe-tuned ``StagedMultistart`` (compacted widths, the fleet loop)
    with host objectives equals the plain torch run lane by lane; the rows
    passed equal the counters in total, and the host function sees the
    same sites as in the plain host run."""
    cfg = RbfConfig(kernel="multiquadric")
    x0 = tsyn.halton_starts(8, LB, UB, 3)
    ac = mt.AlgorithmConfig(max_iter=16)
    ref = mt.multistart_optimize(tsyn.make_two_parabolas(cfg, LB, UB), x0, ac, F64, "cpu")
    plain_mop, plain_recs = _host_parabolas(cfg)
    build_solver(plain_mop, ac, F64, "cpu").solve(x0)
    mop, recs = _host_parabolas(cfg)
    probe = StagedMultistart(mop, ac, F64, device="cpu")
    first = probe(x0)
    runner = probe.tuned(first.n_iterations, quantum=2,
                         db_capacity=suggest_db_capacity(first))
    assert any(w < 8 for w in runner.widths)
    for r in recs:
        r.sites.clear()
    res = runner(x0)
    for f in ("x", "fx", "stop_code", "n_iterations", "n_evals"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    for rec, prec in zip(recs, plain_recs):
        assert rec.rows == int(res.state.groups[0].n_evals.sum())
        key = lambda r: np.sort(np.concatenate(r.sites).view("f8,f8"), axis=0)
        np.testing.assert_array_equal(key(rec), key(prec))


@pytest.mark.parametrize("adder", ["add_rbf_objective", "add_lagrange_objective",
                                   "add_taylor_objective"])
def test_family_adders_match_jax(adder):
    """``MOP.add_rbf_objective`` and its siblings build the config from
    keyword arguments, as the JAX adders do: the compiled groups, members
    and configs equal JAX's."""
    kw = {"add_rbf_objective": dict(kernel="cubic", max_model_points=5),
          "add_lagrange_objective": dict(degree=1),
          "add_taylor_objective": dict(degree=1, mode="callback")}[adder]
    structure = {}
    for port, MOP, s in ((True, mt.MOP, torch), (False, JaxMOP, jnp)):
        mop = MOP(LB, UB)
        getattr(mop, adder)(lambda x: s.sum((x - 1.0) ** 2), **kw)
        getattr(mop, adder)(lambda x: s.sum((x + 1.0) ** 2), **kw)
        cm = (compile_mop if port else jax_compile_mop)(mop)
        structure[port] = ([(type(g.cfg).__name__, sorted(vars(g.cfg).items()), g.m,
                             [(mb.fn_index, mb.group_offset, mb.global_offset, mb.role)
                              for mb in g.members]) for g in cm.groups], cm.m_obj)
    assert structure[True] == structure[False]
    mop = mt.MOP(LB, UB)
    getattr(mop, adder)(lambda x: torch.sum(x ** 2), **kw)
    res = mt.optimize(mop, [0.5, -0.5], max_iter=1, device="cpu")
    assert int(res.n_iterations) == 1 and torch.isfinite(res.x).all()


def test_auto_scaler_takes_finite_differences_of_host_groups():
    """``var_scaler='auto'`` without a box estimates the scaling from the
    groups' Jacobians at the perturbed start; a host group's Jacobian is
    its central differences there, as in the JAX package (1e-12)."""
    from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
    from morbit_tpu_torch.core.algorithm import Solver

    x0 = np.array([0.5, -2.0])
    fns = (lambda x: np.sum((x - 1.0) * (x - 1.0) * np.array([1.0, 1e3])),
           lambda x: np.sum((x + 1.0) * (x + 1.0)))
    scales = []
    for port, MOP, Exact in ((True, mt.MOP, ExactConfig), (False, JaxMOP, JaxExact)):
        mop = MOP(2)
        for f in fns:
            mop.add_objective(f, model_cfg=Exact(), host=True)
        if port:
            s = Solver(compile_mop(mop), mt.AlgorithmConfig(var_scaler="auto"), F64, "cpu",
                       x0_hint=x0)
            scales.append(s.scal.scale.numpy())
        else:
            s = jalg.Solver(jax_compile_mop(mop), JaxConfig(var_scaler="auto"), jnp.float64,
                            x0_hint=x0)
            scales.append(np.asarray(s.scal.scale))
    assert mop.functions[0].host
    np.testing.assert_allclose(scales[0], scales[1], rtol=1e-12, atol=0)
    assert not np.allclose(scales[0], 1.0)
