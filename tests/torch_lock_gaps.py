"""The float gaps between the port and the JAX package on the two lanes that
the JAX locks hold looser than 1e-10, by max_iter, at float64 on the CPU.

* ``test_torch_benchmarks.TWO_PARABOLAS_POLISH_LANE``: ``perform_test`` on
  ``two_parabolas-n2-exact-steepest_descent-s3`` (qp_iters=100);
* ``test_torch_compacted.ZDT1_DEGENERATE_LP_LANE``: the plain runners on
  exact ZDT1 at n=5, B=8 Halton starts (qp_iters=100), and the compacted
  runners of ``test_compacted_matches_jax_on_exact_zdt1`` leaf by leaf.

A lane's first max_iter with a gap above ~1e-14 is the iteration where it
parts. One JSON line per reading::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_lock_gaps.py
"""

import json

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import morbit_tpu.parallel.benchmarks as jb  # noqa: E402
import morbit_tpu.parallel.multistart as jms  # noqa: E402
import morbit_tpu.problems.synthetic as jsyn  # noqa: E402
import morbit_tpu_torch as mt  # noqa: E402
import morbit_tpu_torch.parallel.benchmarks as tb  # noqa: E402
import morbit_tpu_torch.problems.synthetic as tsyn  # noqa: E402
from morbit_tpu.core.config import AlgorithmConfig as JaxConfig  # noqa: E402
from morbit_tpu_torch.utils.carry import state_to_numpy  # noqa: E402
from test_torch_benchmarks import TWO_PARABOLAS, TWO_PARABOLAS_POLISH_LANE  # noqa: E402
from test_torch_compacted import ZDT1_DEGENERATE_LP_LANE, _jax_leaves  # noqa: E402


def _lane_gap(a, b, lane):
    a, b = np.asarray(a, float), np.asarray(b, float)
    both = np.isfinite(a) & np.isfinite(b)
    with np.errstate(invalid="ignore"):
        return float(np.where(both, np.abs(a - b), 0.0)[lane].max(initial=0.0))


def main():
    lane = TWO_PARABOLAS_POLISH_LANE
    for max_iter in range(1, 7):
        kw = dict(max_iter=max_iter, qp_iters=100)
        theirs = jb.perform_test(jb.Setting(*TWO_PARABOLAS), dtype=jnp.float64, **kw)
        ours = tb.perform_test(tb.Setting(*TWO_PARABOLAS), dtype=torch.float64,
                               device="cpu", **kw)
        print(json.dumps({"setting": "two_parabolas", "lane": lane, "max_iter": max_iter,
                          **{k: _lane_gap(ours[k], theirs[k], lane)
                             for k in ("x", "fx", "omega")},
                          "integers_equal": all(np.array_equal(ours[k], theirs[k]) for k in
                                                ("n_evals", "n_iterations", "stop_code"))}))
    lane = ZDT1_DEGENERATE_LP_LANE
    jmop = jsyn.make_zdt("zdt1", 5)
    x0 = jsyn.halton_starts(8, jmop.lb, jmop.ub)
    for max_iter in range(1, 11):
        kw = dict(max_iter=max_iter, qp_iters=100)
        ref = jms.multistart_optimize(jmop, x0, JaxConfig(**kw), dtype=jnp.float64)
        res = mt.multistart_optimize(tsyn.make_zdt("zdt1", 5), x0, mt.AlgorithmConfig(**kw),
                                     dtype=torch.float64, device="cpu")
        print(json.dumps({"setting": "zdt1-n5-exact", "lane": lane, "max_iter": max_iter,
                          "x": _lane_gap(res.x, ref.x, lane),
                          "fx": _lane_gap(res.fx, ref.fx, lane)}))
    kw = dict(max_iter=10, qp_iters=100)
    ref = jms.compacted_multistart(jmop, x0, JaxConfig(**kw), dtype=jnp.float64,
                                   stage_iters=3, bucket_ladder=(8, 4))
    res = mt.compacted_multistart(tsyn.make_zdt("zdt1", 5), x0, mt.AlgorithmConfig(**kw),
                                  torch.float64, stage_iters=3, bucket_ladder=(8, 4),
                                  device="cpu")
    ours, theirs = state_to_numpy(res.state), _jax_leaves(ref.state)
    print(json.dumps({"setting": "zdt1-n5-exact compacted", "lane": lane,
                      "leaves": {k: _lane_gap(ours[k], v, lane) for k, v in theirs.items()
                                 if v.dtype.kind == "f" and v.size}}))


if __name__ == "__main__":
    main()
