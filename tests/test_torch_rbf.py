"""The port's RBF surrogate against the JAX package and the oracles.

At float64 on the CPU, on seeded numpy inputs:

* the RBF math (``ops/rbf.py``), the affine point filter (``ops/affine.py``)
  and the plain twins of the kernels K2 (rounds 1-3) and K3 (round 4)
  against their JAX functions;
* ``optimize`` on the RBF golden (``tests/golden/two_parabolas_rbf_mq_f64.json``,
  round 4 on) and on the full-oracle RBF configs of
  ``tests/test_oracle_full_parity.py``;
* ``multistart_optimize`` on the RBF main path against JAX lane by lane and
  against the port's own B=1 runs; ``optimize`` on model variants (two
  groups with training-set reuse, coordinate sampling, a radius-dependent
  shape parameter) with model-meta stamps; and every outer trip of a run
  carried over from JAX states.

The JAX side runs its plain (non-Pallas) routes: float64 never takes them.
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
import morbit_tpu.models.rbf_model as jrbfm
import morbit_tpu.ops.affine as jaff
import morbit_tpu.ops.rbf as jrbf
import morbit_tpu.parallel.multistart as jms
import morbit_tpu.problems.synthetic as jsyn
import morbit_tpu_torch as mt
import morbit_tpu_torch.ops.affine as taff
import morbit_tpu_torch.ops.rbf as trbf
import morbit_tpu_torch.problems.synthetic as tsyn
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu.core.mop import MOP as JaxMOP
from morbit_tpu.core.mop import compile_mop as jax_compile_mop
from morbit_tpu.models.configs import RbfConfig as JaxRbf
from morbit_tpu.models.rbf_round4 import run_round4 as jax_run_round4
from morbit_tpu.utils.logging import trajectory_arrays as jax_trajectory_arrays
from morbit_tpu.utils.parity import compare_trajectories
from morbit_tpu_torch.core.algorithm import Solver
from morbit_tpu_torch.core.mop import compile_mop
from morbit_tpu_torch.models.configs import RbfConfig
from morbit_tpu_torch.models.rbf_round4 import run_round4
from morbit_tpu_torch.ops.prepare_coord import rbf_selection_core
from morbit_tpu_torch.utils.carry import (config_from_dict, state_from_numpy,
                                          state_to_numpy)
from morbit_tpu_torch.utils.logging import trajectory_arrays
from morbit_tpu_torch.utils.parity import export_trajectory
from chip_smoke import (SEL_NAMES, SEL_STATICS, round4_case, selection_case,
                        selection_lattice_case)
from tests.oracle_full import GroupSpec, solve_oracle_full
from tests.test_oracle_full_parity import _assert_parity

TOL = 1e-12
LB2, UB2 = [-4.0, -4.0], [4.0, 4.0]
F64 = torch.float64


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0, atol=tol)


def _equal(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


# ----------------------------------------------------------------- RBF math

@pytest.mark.parametrize("kernel", trbf.RBF_KERNELS)
def test_kernels_match_jax(kernel):
    rng = np.random.default_rng(0)
    r2 = rng.uniform(0, 3, (4, 7))
    r2[0, 0] = 0.0
    param = trbf.kernel_default_param(kernel) if kernel in trbf.EXPONENT_KERNELS else 1.7
    assert trbf.kernel_default_param(kernel) == jrbf.kernel_default_param(kernel)
    _close(trbf.apply_kernel(kernel, _t(r2), param),
           jrbf.apply_kernel(kernel, jnp.asarray(r2), param))
    # d phi / d r^2 against autodiff of the JAX kernel, zero at r = 0
    dphi = jax.vmap(jax.grad(lambda v: jrbf.apply_kernel(kernel, v, param)))(
        jnp.asarray(r2.ravel()))
    _close(trbf.kernel_derivative(kernel, _t(r2), param).reshape(-1), dphi)
    x = rng.normal(size=(3, 2))
    for deg in (-1, 0, 1):
        assert trbf.poly_dim(2, deg) == jrbf.poly_dim(2, deg)
        _close(trbf.poly_basis(_t(x), deg),
               jax.vmap(lambda v: jrbf.poly_basis(v, deg))(jnp.asarray(x)))


def _training_sets(deg, B=6, P=8, n=2, m=2, seed=1):
    rng = np.random.default_rng(seed)
    sites = rng.uniform(-1, 1, (B, P, n))
    values = rng.normal(size=(B, P, m))
    n_valid = rng.integers(1, P + 1, B)
    n_valid[0] = P
    # lane 1 has fewer valid points than the polynomial tail: the KKT system
    # is singular and the fit takes the residual-checked ridge fallback
    n_valid[1] = trbf.poly_dim(n, deg) - 1
    return sites, values, np.arange(P)[None, :] < n_valid[:, None]


@pytest.mark.parametrize("kernel,deg", [("multiquadric", 1), ("cubic", 1),
                                        ("gaussian", 0), ("inv_multiquadric", 1),
                                        ("thin_plate_spline", 1)])
def test_fit_eval_jacobian_match_jax(kernel, deg):
    sites, values, mask = _training_sets(deg)
    param = None if kernel in trbf.EXPONENT_KERNELS else 1.3
    fit = trbf.fit_rbf(_t(sites), _t(values), torch.as_tensor(mask),
                       kernel=kernel, param=param, poly_deg=deg)
    jfit = jax.vmap(lambda s, v, k: jrbf.fit_rbf(s, v, k, kernel=kernel,
                                                 param=param, poly_deg=deg))(
        jnp.asarray(sites), jnp.asarray(values), jnp.asarray(mask))
    X = np.random.default_rng(2).uniform(-1, 1, (sites.shape[0], 3, 2))
    X[:, 0] = sites[:, 0]                      # at a training site (r = 0)
    vals = trbf.eval_rbf(fit, _t(X), kernel, deg)
    jvals = jax.vmap(lambda f, xs: jax.vmap(
        lambda x: jrbf.eval_rbf(f, x, kernel, deg))(xs))(jfit, jnp.asarray(X))
    Js = [trbf.rbf_jacobian(fit, _t(X[:, q]), kernel, deg) for q in range(3)]
    jJs = [jax.vmap(lambda f, x: jrbf.rbf_jacobian(f, x, kernel, deg))(
        jfit, jnp.asarray(X[:, q])) for q in range(3)]
    # well-posed lanes: coefficients to a few ulps of their size (up to ~1e3)
    ok = np.arange(sites.shape[0]) != 1
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a)[ok], np.asarray(b)[ok], rtol=1e-11, atol=1e-11)
    close(fit.w, jfit.w)
    close(fit.lam, jfit.lam)
    close(vals, jvals)
    for J, jJ in zip(Js, jJs):
        close(J, jJ)
    # the singular lane: the ridge solve (ridge 1e2 eps) is conditioned
    # like 1/ridge, so the two LU orders agree only on what the data pins
    # down: both models interpolate the valid sites
    k = int(mask[1].sum())
    at = _t(sites[1:2, :k])
    fit1 = trbf.RbfFit(*(f[1:2] for f in fit))
    _close(trbf.eval_rbf(fit1, at, kernel, deg)[0], values[1, :k], 1e-6)
    jfit1 = jax.tree_util.tree_map(lambda a: a[1], jfit)
    _close(jax.vmap(lambda x: jrbf.eval_rbf(jfit1, x, kernel, deg))(
        jnp.asarray(sites[1, :k])), values[1, :k], 1e-6)
    assert torch.isfinite(fit.w).all() and torch.isfinite(fit.lam).all()


def test_f32_fit_beyond_unrolled_solve_raises():
    """A float32 fit whose KKT system is past the unrolled size (k = 30)
    takes the blocked Gauss-Jordan solve, as in JAX; both models agree and
    reproduce their data to the f32 rounding of a system conditioned ~1e3.
    (The name is the one this test had while that solve was not ported and
    such a fit raised.)"""
    rng = np.random.default_rng(7)
    sites = np.stack([tsyn.halton(24, 5, 1 + 24 * b) for b in range(3)]).astype(np.float32)
    values = rng.normal(size=(3, 24, 2)).astype(np.float32)
    mask = np.arange(24)[None, :] < np.array([24, 20, 9])[:, None]
    fit = trbf.fit_rbf(torch.as_tensor(sites), torch.as_tensor(values),
                       torch.as_tensor(mask), kernel="cubic", poly_deg=1)
    jfit = jax.vmap(lambda s, v, k: jrbf.fit_rbf(s, v, k, kernel="cubic", poly_deg=1))(
        jnp.asarray(sites), jnp.asarray(values), jnp.asarray(mask))
    at = trbf.eval_rbf(fit, torch.as_tensor(sites), "cubic", 1).numpy()
    jat = jax.vmap(lambda f, xs: jax.vmap(lambda x: jrbf.eval_rbf(f, x, "cubic", 1))(xs))(
        jfit, jnp.asarray(sites))
    np.testing.assert_allclose(at, np.asarray(jat), rtol=0, atol=5e-4)
    np.testing.assert_allclose(at[mask], values[mask], rtol=0, atol=5e-4)


def test_use_max_points_raises():
    """(The name is kept from when it raised.) ``use_max_points`` is
    ported: a problem with it builds and solves one iteration
    (``tests/test_torch_max_points.py`` holds it against the JAX
    package)."""
    mop = mt.MOP([-1.0], [1.0])
    mop.add_objective(lambda x: (x ** 2).sum(), model_cfg=RbfConfig(use_max_points=True))
    res = mt.optimize(mop, [0.5], max_iter=1, device="cpu")
    assert int(res.n_iterations) == 1 and torch.isfinite(res.x).all()


# ------------------------------------------------------------ affine filter

@pytest.mark.parametrize("n", [2, 3])
def test_affine_selection_matches_jax(n):
    rng = np.random.default_rng(10 + n)
    B, cap = 8, 19
    x0 = rng.uniform(0.2, 0.8, (B, n))
    seeds = rng.uniform(0, 1, (B, cap, n))
    seeds[:, 3] = seeds[:, 2]                  # a duplicate row (exact tie)
    mask = rng.uniform(size=(B, cap)) < 0.6
    piv = rng.uniform(0.01, 0.2, B)
    n_pick = rng.integers(0, n + 1, B)
    sel = taff.affinely_independent_points(_t(x0), _t(seeds), torch.as_tensor(mask),
                                           _t(piv), torch.as_tensor(n_pick))
    jsel = jax.vmap(jaff.affinely_independent_points)(
        jnp.asarray(x0), jnp.asarray(seeds), jnp.asarray(mask), jnp.asarray(piv),
        jnp.asarray(n_pick))
    _equal(sel.order, jsel.order)
    _equal(sel.n_picked, jsel.n_picked)
    _equal(sel.k, jsel.k)
    _close(sel.Y, jsel.Y)
    _close(sel.Z, jsel.Z)
    dirs, cnt = taff.improving_directions_from(sel.Z, sel.k)
    jdirs, jcnt = jax.vmap(jaff.improving_directions_from)(jsel.Z, jsel.k)
    _close(dirs, jdirs)
    _equal(cnt, jcnt)


# ------------------------------------------------- kernel twins (K2 and K3)


@pytest.mark.parametrize("efl", ["false", "true", "mixed"])
@pytest.mark.parametrize("n,case", [(2, "random"), (3, "random"), (2, "lattice"),
                                    (3, "lattice")],
                         ids=["2", "3", "2-lattice", "3-lattice"])
def test_selection_twin_matches_jax(n, case, efl):
    """K2's twin against JAX's ``rbf_selection_core``, also on lattice sites
    whose scores tie exactly (with empty lanes and counts past the
    capacity): the kernel equals the twin to the bit on the card, so the
    chain kernel = twin = JAX holds on ties."""
    rng = np.random.default_rng(42 + n)
    make = selection_case if case == "random" else selection_lattice_case
    args = make(rng, 8, 23, n, efl)
    port = rbf_selection_core(
        _t(args[0]), torch.as_tensor(args[1]), _t(args[2]), torch.as_tensor(args[3]),
        _t(args[4]), _t(args[5]), _t(args[6]), torch.as_tensor(args[7]),
        torch.as_tensor(args[8]), **SEL_STATICS)
    kw = dict(SEL_STATICS, n=n)
    ref = jax.vmap(lambda *a: jrbfm.rbf_selection_core(
        *a[:8], ensure_fully_linear=a[8], **kw))(*map(jnp.asarray, args))
    for name, p, r in zip(SEL_NAMES, port, ref):
        if np.asarray(r).dtype.kind == "f":
            _close(p, r)
        else:
            _equal(p, r)


@pytest.mark.parametrize("kernel,deg", [("multiquadric", 1), ("cubic", 1),
                                        ("multiquadric", 0)])
def test_round4_twin_matches_jax(kernel, deg):
    rng = np.random.default_rng(11)
    B, C, n, maxN = 8, 23, 2, 6
    X, cand, init, count, param = round4_case(rng, B, C, n, maxN, 0.4)
    chol_pivot = 0.3 if deg == 0 else 1e-2
    static = 3 if kernel == "cubic" else None
    acc, N = run_round4(_t(X), torch.as_tensor(cand), _t(init), torch.as_tensor(count),
                        kernel=kernel, param=static if static else _t(param),
                        poly_deg=deg, max_points=maxN, chol_pivot=chol_pivot)

    def ref_one(Xi, ci, si, cnt, par):
        st = jax_run_round4(Xi, ci, si, cnt, kernel=kernel,
                            param=static if static else par, poly_deg=deg,
                            max_points=maxN,
                            chol_pivot=jnp.asarray(chol_pivot, jnp.float64))
        return st.accepted, st.N

    jacc, jN = jax.vmap(ref_one)(*map(jnp.asarray, (X, cand, init, count, param)))
    _equal(N, jN)
    _equal(acc, jacc)
    assert int(N.min()) < maxN                 # rejections occur


# ------------------------------------------------------------ whole solves

def _rbf_mop(port: bool, kernel="multiquadric", **cfg_kw):
    if port:
        mop, cfg, s = mt.MOP(LB2, UB2), RbfConfig(kernel=kernel, **cfg_kw), torch
    else:
        mop, cfg, s = JaxMOP(LB2, UB2), JaxRbf(kernel=kernel, **cfg_kw), jnp
    mop.add_objective(lambda x: s.sum((x - 1.0) ** 2), model_cfg=cfg)
    mop.add_objective(lambda x: s.sum((x + 1.0) ** 2), model_cfg=cfg)
    return mop


def test_trajectory_matches_rbf_golden():
    res = mt.optimize(_rbf_mop(True), [-3.141592653589793, 2.71828],
                      max_iter=15, device="cpu", dtype=F64)
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "two_parabolas_rbf_mq_f64.json")) as f:
        golden = json.load(f)
    rep = compare_trajectories(export_trajectory(res), golden, x_tol=1e-10)
    assert rep["parity"], rep


def _oracle_case(kernel, **kw):
    F = lambda x: np.array([np.sum((x - 1.0) ** 2), np.sum((x + 1.0) ** 2)])
    J = lambda x: np.stack([2.0 * (x - 1.0), 2.0 * (x + 1.0)])
    return kernel, [GroupSpec(role="obj", m=2, F=F, J=J, kind="rbf", kernel=kernel)], kw


# the RBF configs of tests/test_oracle_full_parity.py, same tolerances
ORACLE = {
    "rbf-mq": _oracle_case("multiquadric", max_iter=11, tol=1e-9),
    "rbf-cubic": _oracle_case("cubic", max_iter=12, tol=1e-8),
    "rbf-critical": _oracle_case("multiquadric", max_iter=30, f_tol_rel=0.0,
                                 x_tol_rel=0.0, tol=5e-2,
                                 tol_overrides={"rho": 1.5}),
    "rbf-steplength-ru": _oracle_case("multiquadric", max_iter=12, tol=1e-8,
                                      radius_update_method="steplength"),
}


@pytest.mark.parametrize("label", ORACLE)
def test_optimize_matches_full_oracle(label):
    kernel, groups, kw = ORACLE[label]
    kw = dict(kw)
    tol = kw.pop("tol")
    overrides = kw.pop("tol_overrides", {})
    x0 = np.array([-3.0, 2.5])
    res = mt.optimize(_rbf_mop(True, kernel, max_model_points=3), x0,
                      device="cpu", dtype=F64, **kw)
    orc = solve_oracle_full(LB2, UB2, groups, x0, **kw)
    _assert_parity(res, orc, tol, overrides)


def _jax_lane(ref, i):
    traj = ref.state.traj
    c = int(traj.count[i])
    return dict(stop_code=int(ref.stop_code[i]), n_iterations=int(ref.n_iterations[i]),
                n_evals=[int(g.n_evals[i]) for g in ref.state.groups],
                it_stat=np.asarray(traj.it_stat[i][:c]),
                x_indices=np.asarray(traj.x_indices[i][:c]),
                x=np.asarray(traj.x[i][:c]), fx=np.asarray(traj.fx[i][:c]),
                x_final=np.asarray(ref.x[i]))


def _assert_lane(port, ref, lane, tol):
    """One lane of a batched port result (``lane=None``: an ``optimize``
    result) against a reference: integers exact, floats within ``tol``."""
    pick = (lambda t: t) if lane is None else (lambda t: t[lane])
    tp = trajectory_arrays(port, lane)
    assert int(pick(port.stop_code)) == ref["stop_code"]
    assert int(pick(port.n_iterations)) == ref["n_iterations"]
    assert [int(pick(g.n_evals)) for g in port.state.groups] == ref["n_evals"]
    assert tp["it_stat"].tolist() == ref["it_stat"].tolist()
    _equal(tp["x_indices"], ref["x_indices"])
    for name in ("x", "fx"):
        _close(tp[name], ref[name], tol)
    _close(pick(port.x), ref["x_final"], tol)


def test_rbf_multistart_matches_jax_and_single_runs():
    """The main path (one multiquadric group, optimized sampling, round 4
    on) at B=4, max_iter=10: lane by lane against JAX's batched solve, and
    against the port's own B=1 runs; and the port's ``StagedMultistart``
    (schedule (3, 6), widths (4, 2, 1)) from JAX's initial state against
    JAX lane by lane.

    JAX's jitted initialization folds the constant radius into the scaling
    offset (``0.125 x + 0.5 + 0.2`` becomes ``0.125 x + 0.7``), which moves
    the last bit of the round-3 box exits; where the two exits of a
    direction tie, that bit picks the side (the tied ``absmax`` exits of
    the full-oracle notes). The port, the NumPy oracle and unjitted JAX
    round each operation in turn, so the lane-by-lane comparison starts
    both solvers from JAX's initial state. Improvement steps meet the same
    tie: their box exits along an inf-normalized direction are equal up to
    the rounding of ``x +- 2 Delta``, so a last-bit difference in the
    iterate (the two KKT solves round differently) can send the two runs
    to different, equally valid sites. Of the first 64 Halton starts, 55
    run identically to ``max_iter=10``; points 10-13 are four of them."""
    B, kw = 4, dict(max_iter=10)
    starts = tsyn.halton_starts(B, LB2, UB2, start_index=10)
    cfg = dict(kernel="multiquadric")
    jmop = jsyn.make_two_parabolas(JaxRbf(**cfg), LB2, UB2)
    ref = jms.multistart_optimize(jmop, jnp.asarray(starts), JaxConfig(**kw),
                                  dtype=jnp.float64)
    jsolver = jalg.Solver(jax_compile_mop(jmop), JaxConfig(**kw), jnp.float64)
    jinit = jax.jit(jax.vmap(jsolver.initialize))(jnp.asarray(starts))
    solver = Solver(compile_mop(tsyn.make_two_parabolas(RbfConfig(**cfg), LB2, UB2)),
                    mt.AlgorithmConfig(**kw), F64, "cpu")
    state, _ = solver.solve_from_state(state_from_numpy(_jax_leaves(jinit), device="cpu"))
    carried = mt.OptimizeResult(x=state.x, fx=state.fx, stop_code=state.stop_code,
                                n_iterations=state.iter_counter - 1,
                                n_evals=state.groups[0].n_evals, state=state, trips=0)
    port = mt.multistart_optimize(
        tsyn.make_two_parabolas(RbfConfig(**cfg), LB2, UB2), starts,
        mt.AlgorithmConfig(**kw), dtype=F64, device="cpu")
    # the staged runner, compacted, from JAX's initial state
    staged = mt.StagedMultistart(
        tsyn.make_two_parabolas(RbfConfig(**cfg), LB2, UB2), mt.AlgorithmConfig(**kw),
        F64, schedule=(3, 6), widths=(4, 2, 1), device="cpu",
    ).solve_from_state(state_from_numpy(_jax_leaves(jinit), device="cpu"))
    for i in range(B):
        _assert_lane(carried, _jax_lane(ref, i), i, 1e-10)
        _assert_lane(staged, _jax_lane(ref, i), i, 1e-10)
        single = mt.optimize(tsyn.make_two_parabolas(RbfConfig(**cfg), LB2, UB2),
                             starts[i], mt.AlgorithmConfig(**kw), dtype=F64,
                             device="cpu")
        one = trajectory_arrays(single)
        _assert_lane(port, dict(stop_code=int(single.stop_code),
                                n_iterations=int(single.n_iterations),
                                n_evals=[int(g.n_evals) for g in single.state.groups],
                                x_final=single.x.numpy(), **one), i, 1e-12)
    assert port.trips >= int(port.n_iterations.max())


# per variant: f1's and f2's RbfConfig keyword arguments, and max_iter
VARIANTS = {
    # two groups with one geometry signature: the second reuses the first's
    # rounds-1-3 set (``RbfModel.jl:311-342``)
    "two-groups-reuse": (dict(kernel="cubic"), dict(kernel="multiquadric"), 10),
    # coordinate-axis sampling every rebuild, rounds 2 and 4 off. Each
    # rebuild puts its sites at box exits that tie up to the rounding of
    # x +- 2 Delta (the tie of the multistart test); from iteration 4 JAX's
    # fused arithmetic and the port's take different sides, so the
    # comparison stops at 3
    "coordinate-sampling": (dict(kernel="multiquadric", optimized_sampling=False),) * 2 + (3,),
    # a radius-dependent shape parameter (``RbfModel.jl:135-143``)
    "shape-of-radius": (dict(kernel="gaussian", shape_parameter=lambda d: 1.0 + 4.0 * d),) * 2
    + (10,),
}


@pytest.mark.parametrize("label", VARIANTS)
def test_optimize_variants_match_jax(label):
    """``optimize`` against JAX's on model variants off the main path, with
    the per-iteration training-set stamps (``save_model_meta``) on."""
    def build(port):
        mop = mt.MOP(LB2, UB2) if port else JaxMOP(LB2, UB2)
        C, s = (RbfConfig, torch) if port else (JaxRbf, jnp)
        c1, c2, _ = VARIANTS[label]
        mop.add_objective(lambda x: s.sum((x - 1.0) ** 2), model_cfg=C(**c1))
        mop.add_objective(lambda x: s.sum((x + 1.0) ** 2), model_cfg=C(**c2))
        return mop

    kw = dict(max_iter=VARIANTS[label][2], save_model_meta=True)
    x0 = np.array([-3.0, 2.5])
    port = mt.optimize(build(True), x0, device="cpu", dtype=F64, **kw)
    ref = jalg.optimize(build(False), jnp.asarray(x0), dtype=jnp.float64, **kw)
    assert len(port.state.groups) == len(ref.state.groups)
    tr = jax_trajectory_arrays(ref)
    _assert_lane(port, dict(
        stop_code=int(ref.stop_code), n_iterations=int(ref.n_iterations),
        n_evals=[int(g.n_evals) for g in ref.state.groups], it_stat=tr["it_stat"],
        x_indices=tr["x_indices"], x=tr["x"], fx=tr["fx"], x_final=np.asarray(ref.x)),
        None, 1e-10)
    # per iteration and group: the training-set size and its db rows (as a
    # set: two picks whose scores tie exactly may come in either order)
    c = int(ref.state.traj.count)
    meta_p = port.state.traj.model_meta[:c].numpy()
    meta_r = np.asarray(ref.state.traj.model_meta)[:c]
    off = 0
    for ops in Solver(compile_mop(build(True)), mt.AlgorithmConfig(), F64,
                      "cpu").container.ops:
        w = ops.train_stamp_len
        for row_p, row_r in zip(meta_p[:, off:off + w], meta_r[:, off:off + w]):
            assert row_p[0] == row_r[0]
            assert sorted(row_p[1:1 + row_p[0]]) == sorted(row_r[1:1 + row_r[0]])
        off += w
    assert off == meta_r.shape[1]


def _jax_leaves(st):
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
        out[f"groups.{i}.model.meta"] = np.asarray(g.model.meta)
        out[f"groups.{i}.model.dirs"] = np.asarray(g.model.dirs)
        out[f"groups.{i}.model.fit.fdata"] = np.asarray(g.model.fit.fdata)
        out[f"groups.{i}.model.fit.flam"] = np.asarray(g.model.fit.flam)
    return out


def test_iterate_from_carried_jax_rbf_state():
    """Every outer trip of an RBF run into the criticality routine: the
    port's ``iterate`` from the carried JAX state equals JAX's next state,
    leaf by leaf (integers exact)."""
    jac = JaxConfig(max_iter=30, f_tol_rel=0.0, x_tol_rel=0.0)
    jsolver = jalg.Solver(jax_compile_mop(_rbf_mop(False)), jac, jnp.float64)
    jiter = jax.jit(jsolver.iterate)
    solver = Solver(compile_mop(_rbf_mop(True)),
                    config_from_dict(dataclasses.asdict(jac)), F64, "cpu")
    st = jax.jit(jsolver.initialize)(jnp.asarray([-3.0, 2.5]))
    modes = set()
    for trip in range(60):
        if int(st.stop_code) != 1:
            break
        nxt = jiter(st)
        port = state_to_numpy(solver.iterate(state_from_numpy(_jax_leaves(st),
                                                              device="cpu")))
        ref = _jax_leaves(nxt)
        assert set(port) == set(ref)
        for name, a in port.items():
            b = ref[name][None]
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=f"trip {trip}: {name}")
            else:
                # near the critical point rho divides tiny model decreases,
                # and the KKT systems of the shrinking radius grow
                # ill-conditioned: weights reach 6e4 and agree to 2e-9
                # relative (the two LU solves round differently)
                tol = 1e-8
                rtol = {"traj.data": 1e-4}.get(name, 1e-7 if ".fit." in name else 0.0)
                np.testing.assert_allclose(a, b, rtol=rtol, atol=tol,
                                           err_msg=f"trip {trip}: {name}")
        modes.add(int(nxt.crit_mode))
        st = nxt
    assert int(st.stop_code) != 1
    assert {1, 2} & modes
