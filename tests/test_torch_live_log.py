"""The port's live in-loop log (``optimize(verbosity=3..5)``,
``Solver(log_level=)``) against the JAX package's ``jax.debug.print``
lines, at float64 on the CPU, and its cost when it is off.

* The main path's problem (two parabolas, one multiquadric RBF group) from
  (-3, 2.5) at max_iter=6, levels 3, 4 and 5, and the constrained
  configuration of ``tools/bench_constrained.py`` (x1 + x2 <= 1, exact
  ||x||^2 <= 2.25) from (2, 1.5) at level 4, whose trips take the normal
  step and restoration: the same lines in the same order, integers and
  booleans equal, floats within 1e-10 relative.
* With the log off a trip reads the device from the host as often as the
  solver did before the log existed (the counts below); with it on, one
  transfer more a trip.
"""

import contextlib
import io
import pathlib
import sys

import jax.numpy as jnp
import pytest
import torch

import morbit_tpu_torch as mt
from morbit_tpu.core.algorithm import optimize as jax_optimize
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig
from morbit_tpu.models.configs import RbfConfig as JaxRbf
from morbit_tpu.problems.synthetic import make_two_parabolas as jax_two_parabolas
from morbit_tpu_torch.models.configs import RbfConfig
from morbit_tpu_torch.problems.synthetic import (halton_starts,
                                                 make_constrained_two_parabolas,
                                                 make_two_parabolas)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))
from bench_constrained import make_constrained as jax_constrained  # noqa: E402
from chip_smoke import same_live_lines  # noqa: E402

LB2, UB2 = [-4.0, -4.0], [4.0, 4.0]
F64 = torch.float64


def _live_lines(text: str) -> list:
    """The live lines of a run's output (the report's lines start "| iter"
    or are the report's frame)."""
    return [ln for ln in text.splitlines()
            if ln.startswith(("| Iteration", "|  ", "|   (Models)"))]


def _problems(case: str):
    """(port's problem, JAX's problem, start, config keywords) of a case."""
    if case == "rbf":
        return (make_two_parabolas(RbfConfig(kernel="multiquadric"), LB2, UB2),
                jax_two_parabolas(JaxRbf(kernel="multiquadric"), LB2, UB2),
                [-3.0, 2.5], dict(max_iter=6))
    return (make_constrained_two_parabolas(RbfConfig(kernel="multiquadric")),
            jax_constrained(), [2.0, 1.5], dict(max_iter=6, qp_iters=100))


#: each line's level: the banner 3, the model builds 5, the others 4
def _level(line: str) -> int:
    return 3 if line.startswith("| Iteration") else 5 if "(Models)" in line else 4


_JAX_LINES = {}


def _jax_lines(case: str, level: int) -> list:
    """JAX's live lines of a case at ``level``: its run at level 5, compiled
    once a case, less the lines of higher levels (the print sites only
    print; each level adds its sites' lines to the lower levels')."""
    if case not in _JAX_LINES:
        _, theirs, x0, kw = _problems(case)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jax_optimize(theirs, jnp.asarray(x0), JaxConfig(**kw), dtype=jnp.float64,
                         verbosity=5)
        _JAX_LINES[case] = _live_lines(out.getvalue())
    return [ln for ln in _JAX_LINES[case] if _level(ln) <= level]


@pytest.mark.parametrize("case,level", [("rbf", 3), ("rbf", 4), ("rbf", 5),
                                        ("constrained", 4)])
def test_live_lines_match_jax(case, level, capfd):
    """The port's lines at ``verbosity=level`` equal JAX's."""
    ours, _, x0, kw = _problems(case)
    jax_lines = _jax_lines(case, level)
    capfd.readouterr()
    mt.optimize(ours, x0, mt.AlgorithmConfig(**kw), dtype=F64, verbosity=level,
                device="cpu")
    port_lines = _live_lines(capfd.readouterr().out)
    assert port_lines, "no live line"
    assert {_level(ln) for ln in port_lines} == set(range(3, level + 1))
    assert same_live_lines(port_lines, jax_lines) is None
    if case == "constrained":
        assert any(ln.startswith("|  Normal step: needed=True") for ln in port_lines)
        assert any(ln.startswith("|  Normal step: needed=False") for ln in port_lines)
        assert any(ln.startswith("|  Restoration: active=True") for ln in port_lines)
        assert any(ln.startswith("|  Restoration: active=False") for ln in port_lines)


#: host reads a trip of ``Solver.iterate`` (``__bool__``, ``item``, ``cpu``,
#: ``tolist`` on a tensor: every way a device value reaches the host) on 8
#: Halton starts at max_iter=6, qp_iters=100, float64, trips 1-12, as the
#: solver made them before the live log existed: the constrained path's
#: outcome skips read once each (``core/algorithm.py``); the RBF path
#: reads once a trip
READS_WITHOUT_LOG = {"rbf": [1] * 12, "constrained": [5] + [2] * 11}


@pytest.mark.parametrize("case", ["rbf", "constrained"])
def test_log_off_adds_no_host_read(case, monkeypatch, capfd):
    """With ``log_level`` below 3 a trip makes the reads it made before
    the log existed; at 4, exactly one more a trip (the log's one transfer)."""
    counts = [0]
    for name in ("__bool__", "item", "cpu", "tolist"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            counts[0] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    mop = (make_two_parabolas(RbfConfig(kernel="multiquadric"), LB2, UB2) if case == "rbf"
           else make_constrained_two_parabolas(RbfConfig(kernel="multiquadric")))
    x0 = halton_starts(8, LB2, UB2)
    per_level = {}
    for level in (0, 2, 4):
        solver = mt.Solver(mt.compile_mop(mop), mt.AlgorithmConfig(max_iter=6, qp_iters=100),
                           F64, "cpu", log_level=level)
        st = solver.initialize(x0)
        per = []
        for _ in range(12):
            counts[0] = 0
            st = solver.iterate(st)
            per.append(counts[0])
        per_level[level] = per
    capfd.readouterr()
    assert per_level[0] == per_level[2] == READS_WITHOUT_LOG[case]
    assert per_level[4] == [r + 1 for r in READS_WITHOUT_LOG[case]]
