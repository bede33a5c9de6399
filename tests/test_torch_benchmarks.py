"""The port's benchmark-grid harness (``morbit_tpu_torch/parallel/benchmarks.py``)
against the JAX package's (``morbit_tpu/parallel/benchmarks.py``), at float64
on the CPU:

* the settings grid (keys and order), the problems, the model and descent
  grids and the reference budget against the JAX package's;
* ``perform_test`` against JAX's ``perform_test`` on two settings:
  integers exact, floats within 1e-10 (one lane of the exact two parabolas
  held within 1e-9, for the reason at ``TWO_PARABOLAS_POLISH_LANE``);
* ``staged=True`` against ``staged=False``, and the steady-state call
  against a plain run on the second half of its starts;
* ``run_benchmarks``: a save file that JAX's ``run_benchmarks`` wrote is
  resumed without running a setting; a setting that raises is recorded as
  an ``error`` entry and the next one runs; ``mesh=`` equals the run
  without one;
* the synthetic problems' derivatives below x0 = 0, where ``sqrt`` meets
  ``maximum(., 0)``, against JAX's (NaN in both).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morbit_tpu.parallel.benchmarks as jb
import morbit_tpu.problems.synthetic as jsyn
import morbit_tpu_torch.parallel.benchmarks as tb
import morbit_tpu_torch.problems.synthetic as tsyn

F64 = torch.float64
OBS = ("x", "fx", "n_evals", "n_iterations", "stop_code", "omega")
TWO_PARABOLAS = ("two_parabolas", 2, "exact", "steepest_descent", 3)
ZDT1_TAYLOR1 = ("zdt1", 2, "taylor1", "steepest_descent", 2)
#: the budget of ``tests/test_benchmarks.py``'s exact two-parabolas runs
SHORT = dict(max_iter=6, qp_iters=100)
#: the lane of the exact two parabolas whose first descent LP the two
#: packages polish differently: after qp_iters=100 the ADMM iterates agree
#: within 1.7e-15, and the port's polish moves the point by 2.1e-8 where
#: JAX's keeps it (the polish's discontinuity on unconverged lanes, ROADMAP
#: 3.5). The lane parts at its first iteration (omega 2.1e-8, fx 5.0e-9
#: apart at max_iter=1) and ends with x 4.9e-10, fx 8.1e-10 and omega
#: 2.4e-10 apart; every integer stays exact
TWO_PARABOLAS_POLISH_LANE = 1
#: that lane's bound: its largest gap, 8.1e-10 (fx), rounded up
TWO_PARABOLAS_POLISH_TOL = 1e-9


# ------------------------------------------------------------------ the grid

@pytest.mark.parametrize("grid", [
    {},
    dict(problems=("zdt1", "dtlz1", "two_parabolas"), n_vars_list=(2, 5),
         models=("rbf_cubic", "taylor2", "exact"), descents=("steepest_descent", "ps"),
         n_starts=4),
])
def test_generate_all_settings_matches_jax(grid):
    """The default grid (36 settings) and a custom one: the same settings,
    keys and order as the JAX package's."""
    ours = tb.generate_all_settings(**grid)
    theirs = jb.generate_all_settings(**grid)
    assert [s.key for s in ours] == [s.key for s in theirs]
    assert [dataclasses.astuple(s) for s in ours] == [dataclasses.astuple(s) for s in theirs]
    if not grid:
        assert len(ours) == 36 and ours[0].key == "zdt1-n2-rbf_cubic-steepest_descent-s8"


def _fields(obj):
    return {k: (_fields(v) if dataclasses.is_dataclass(v) else v)
            for k, v in dataclasses.asdict(obj).items()} if obj is not None else None


@pytest.mark.parametrize("descent", sorted(jb.DESCENTS))
def test_default_config_and_model_grid_match_jax(descent):
    """``_default_config`` (the reference budget, overrides on top) and every
    entry of ``MODEL_CFGS`` equal the JAX package's field by field."""
    s = ("zdt1", 5, "rbf_cubic", descent, 8)
    for over in ({}, dict(max_iter=7, qp_iters=50)):
        ours = dataclasses.asdict(tb._default_config(tb.Setting(*s), **over))
        theirs = dataclasses.asdict(jb._default_config(jb.Setting(*s), **over))
        assert ours == theirs
    assert sorted(tb.MODEL_CFGS) == sorted(jb.MODEL_CFGS)
    for name in tb.MODEL_CFGS:
        ours, theirs = tb.MODEL_CFGS[name](), jb.MODEL_CFGS[name]()
        assert type(ours).__name__ == type(theirs).__name__
        assert _fields(ours) == _fields(theirs)


@pytest.mark.parametrize("problem,n", [("zdt1", 5), ("zdt2", 2), ("zdt3", 10), ("dtlz1", 5),
                                       ("dtlz6", 4), ("two_parabolas", 2)])
def test_make_problem_matches_jax(problem, n):
    """The problems of the grid: bounds, and the objective values at Halton
    points of the box equal the JAX package's."""
    ours = tb.make_problem(problem, n, "exact")
    theirs = jb.make_problem(problem, n, "exact")
    assert ours.n_vars == theirs.n_vars == n
    assert len(ours.functions) == len(theirs.functions) == 2
    np.testing.assert_array_equal(ours.lb, theirs.lb)
    np.testing.assert_array_equal(ours.ub, theirs.ub)
    for x in jsyn.halton_starts(4, theirs.lb, theirs.ub):
        for f, g in zip(ours.functions, theirs.functions):
            np.testing.assert_allclose(float(f.fn(torch.as_tensor(x))),
                                       float(g.fn(jnp.asarray(x))), rtol=1e-13, atol=1e-13)


def test_make_problem_rejects_an_unknown_name():
    with pytest.raises(ValueError, match="unknown problem"):
        tb.make_problem("nosuch", 2, "exact")


@pytest.mark.parametrize("name", ["zdt1", "zdt3", "zdt4", "dtlz6"])
def test_problem_derivatives_below_zero_match_jax(name):
    """Below x0 = 0 ZDT1/3/4's f2 is sqrt(maximum(x0/g, 0)), whose derivative
    is infinite times zero: NaN in JAX, and NaN in the port (``_pos``
    multiplies by its slope; torch's ``maximum`` would mask it to 0). At,
    above and below the kink the port's reverse-mode gradients equal JAX's,
    NaN included; so for DTLZ6's sum of maximum(x, 0)^0.1 below 0."""
    n = 4
    if name == "dtlz6":
        tf = tsyn.make_dtlz(6, n).functions[0].fn
        jf = jsyn.make_dtlz(6, n).functions[0].fn
        pts = np.array([[0.3, 0.2, -0.1, 0.4], [0.3, 0.2, 0.0, 0.4], [0.3, 0.2, 0.1, 0.4]])
    else:
        tf = tsyn.zdt_objectives(name, n)[1]
        jf = jsyn.zdt_objectives(name, n)[1]
        pts = np.array([[-0.02, 0.03, 0.03, 0.04], [0.0, 0.1, 0.2, 0.3],
                        [0.25, 0.1, 0.2, 0.3]])
    for x in pts:
        xt = torch.tensor(x, requires_grad=True)
        tf(xt).backward()
        want = np.asarray(jax.grad(jf)(jnp.asarray(x)))
        np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-14, atol=0,
                                   equal_nan=True)
        assert float(tf(torch.tensor(x))) == float(jf(jnp.asarray(x)))


# ------------------------------------------------------------- perform_test

@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """JAX's ``run_benchmarks`` on the exact two parabolas at the short
    budget, saved to a file, and JAX's ``perform_test`` on the Taylor-1 ZDT1
    setting at the reference budget."""
    path = tmp_path_factory.mktemp("bench") / "jax_bench.json"
    saved = jb.run_benchmarks([jb.Setting(*TWO_PARABOLAS)], save_path=str(path),
                              dtype=jnp.float64, verbose=False, **SHORT)
    zdt = jb.perform_test(jb.Setting(*ZDT1_TAYLOR1), dtype=jnp.float64)
    return path, saved, zdt


def _assert_obs_equal(ours, theirs, tol):
    """Observations of one setting: integers exact, floats within ``tol``
    (a number, or one per lane)."""
    for k in OBS:
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        assert a.shape == b.shape, k
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            lim = np.reshape(tol, np.shape(tol) + (1,) * (a.ndim - np.ndim(tol)))
            assert np.all(np.abs(a - b) <= lim), (k, np.abs(a - b).max())


def test_perform_test_matches_jax_two_parabolas(jax_saved):
    """``two_parabolas-n2-exact-steepest_descent-s3`` at max_iter=6,
    qp_iters=100: the observations equal JAX's; floats within 1e-10 on
    every lane but ``TWO_PARABOLAS_POLISH_LANE`` (1e-9), the only lane
    beyond 1e-10."""
    _, saved, _ = jax_saved
    theirs = saved[jb.Setting(*TWO_PARABOLAS).key]
    ours = tb.perform_test(tb.Setting(*TWO_PARABOLAS), dtype=F64, device="cpu", **SHORT)
    assert ours["x"].dtype == np.float64 and ours["n_evals"].dtype == np.int32
    tol = np.full(3, 1e-10)
    tol[TWO_PARABOLAS_POLISH_LANE] = TWO_PARABOLAS_POLISH_TOL
    _assert_obs_equal(ours, theirs, tol)
    dx = np.abs(ours["x"] - np.asarray(theirs["x"])).max(-1)
    assert np.flatnonzero(dx > 1e-10).tolist() in ([], [TWO_PARABOLAS_POLISH_LANE])
    assert ours["wall_s"] > 0 and "steady_state_s" not in ours


def test_perform_test_matches_jax_zdt1_taylor1(jax_saved):
    """``zdt1-n2-taylor1-steepest_descent-s2`` at the reference budget
    (``_default_config``): integers exact, floats within 1e-10."""
    _, _, theirs = jax_saved
    ours = tb.perform_test(tb.Setting(*ZDT1_TAYLOR1), dtype=F64, device="cpu")
    _assert_obs_equal(ours, theirs, 1e-10)
    assert set(ours) == set(theirs)


@pytest.mark.parametrize("key", [TWO_PARABOLAS, ("zdt1", 2, "rbf_cubic", "steepest_descent", 4)])
def test_perform_test_staged_gives_the_same_observations(key):
    """``staged=True`` (``StagedMultistart``) gives the observations of
    ``staged=False`` (``multistart_optimize``): integers exact, floats
    within 1e-12."""
    s = tb.Setting(*key)
    plain = tb.perform_test(s, dtype=F64, device="cpu", **SHORT)
    staged = tb.perform_test(s, dtype=F64, device="cpu", staged=True, **SHORT)
    _assert_obs_equal(staged, plain, 1e-12)


def test_perform_test_steady_state_runs_the_second_half(monkeypatch):
    """``steady_state=True`` returns the first half's observations (equal to
    ``perform_test`` without it) and times a second call on the second half
    of 2 n_starts Halton starts, which equals a plain run there. The port
    compiles nothing per setting, so ``wall_s > steady_state_s`` is not
    asserted (the JAX test's compile split)."""
    s = tb.Setting("two_parabolas", 2, "exact", "steepest_descent", 2)
    kw = dict(max_iter=4, qp_iters=50)
    runs = []
    run = tb.multistart_optimize

    def recorded(*args, **kwargs):
        runs.append(run(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(tb, "multistart_optimize", recorded)
    obs = tb.perform_test(s, dtype=F64, device="cpu", steady_state=True, **kw)
    assert len(runs) == 2
    assert obs["steady_state_s"] > 0 and obs["steady_runs_per_sec"] > 0
    assert obs["compile_s_approx"] == round(obs["wall_s"] - obs["steady_state_s"], 3)
    single = tb.perform_test(s, dtype=F64, device="cpu", **kw)
    _assert_obs_equal(obs, single, 0.0)
    mop = tb.make_problem("two_parabolas", 2, "exact")
    second = tsyn.halton_starts(4, mop.lb, mop.ub)[2:]
    ref = run(mop, second, tb._default_config(s, **kw), F64, "cpu")
    for k in ("x", "fx", "n_evals", "n_iterations", "stop_code"):
        assert torch.equal(getattr(runs[1], k), getattr(ref, k)), k


# ----------------------------------------------------------- run_benchmarks

def test_run_benchmarks_resumes_a_jax_save_file(jax_saved, tmp_path, monkeypatch):
    """A save file that JAX's ``run_benchmarks`` wrote: the port's resumes
    it and runs no setting (``perform_test`` is never called); the results
    are the file's entries, and the file is rewritten with them."""
    path, saved, _ = jax_saved
    calls = []
    monkeypatch.setattr(tb, "perform_test", lambda *a, **k: calls.append(a))
    copy = tmp_path / "bench.json"
    copy.write_text(path.read_text())
    res = tb.run_benchmarks([tb.Setting(*TWO_PARABOLAS)], save_path=str(copy),
                            dtype=F64, device="cpu", verbose=False, **SHORT)
    assert calls == []
    assert res == json.loads(path.read_text()) == json.loads(json.dumps(saved))
    assert json.loads(copy.read_text()) == res


def test_run_benchmarks_records_an_error_and_goes_on(tmp_path):
    """A setting whose problem is unknown is recorded as ``{"error": ...}``;
    the next setting still runs, and both are saved. A second call on the
    same file runs nothing and returns the same entries."""
    path = tmp_path / "bench.json"
    bad = tb.Setting("nosuch", 2, "exact", "steepest_descent", 2)
    good = tb.Setting("two_parabolas", 2, "exact", "steepest_descent", 2)
    kw = dict(max_iter=4, qp_iters=50)
    res = tb.run_benchmarks([bad, good], save_path=str(path), dtype=F64, device="cpu",
                            verbose=False, **kw)
    assert list(res) == [bad.key, good.key]
    assert set(res[bad.key]) == {"error"} and "unknown problem" in res[bad.key]["error"]
    assert len(res[good.key]["n_evals"]) == 2 and all(e > 0 for e in res[good.key]["n_evals"])
    assert json.loads(path.read_text()) == res
    again = tb.run_benchmarks([bad, good], save_path=str(path), dtype=F64, device="cpu",
                              verbose=False, **kw)
    assert again == res


def test_mesh_raises_naming_its_item():
    """(The name is kept from when the argument raised.) ``mesh=`` on
    ``perform_test`` and ``run_benchmarks``: with a mesh of two CPU devices
    the observations equal those without one."""
    s = tb.Setting("two_parabolas", 2, "exact", "steepest_descent", 4)
    kw = dict(max_iter=4, qp_iters=50)
    ours = tb.perform_test(s, dtype=F64, device="cpu", mesh=["cpu", "cpu"], **kw)
    ref = tb.perform_test(s, dtype=F64, device="cpu", **kw)
    _assert_obs_equal(ours, ref, 0.0)
    res = tb.run_benchmarks([s], dtype=F64, device="cpu", mesh=["cpu", "cpu"], verbose=False,
                            **kw)
    assert res[s.key]["n_evals"] == ref["n_evals"].tolist()
    assert res[s.key]["x"] == ref["x"].tolist()
