"""The ``mesh`` form of the port's runners at float64 on the CPU, with a mesh
of four ``"cpu"`` devices: each runner's sharded run against its unsharded
run, leaf by leaf (the JAX package's ``tests/test_multistart.py:55, 306,
357`` as port-against-unsharded cases), ``parametric_multistart(mesh=)``,
and ``entry.dryrun_multichip(4, device="cpu")``.

Every leaf is compared bitwise: each shard is an independent batch, and
the port's float64 operations on the CPU give each lane the same bits at
any batch width.
"""

import numpy as np
import pytest
import torch

import morbit_tpu_torch as mt
import morbit_tpu_torch.parallel.multistart as tms
import morbit_tpu_torch.problems.synthetic as tsyn
from morbit_tpu_torch.entry import dryrun_multichip
from morbit_tpu_torch.models.configs import RbfConfig
from morbit_tpu_torch.utils.carry import state_to_numpy

LB2, UB2 = [-4.0, -4.0], [4.0, 4.0]
F64 = torch.float64
MESH = ["cpu"] * 4


def _assert_bitwise(res, ref, canonical=False):
    """Every leaf of the state equal to the bit (after
    ``canonicalize_buffer_tails`` where the fleet loop leaves junk past the
    fill counters), and the result's integer fields."""
    a, b = res.state, ref.state
    if canonical:
        a, b = tms.canonicalize_buffer_tails(a), tms.canonicalize_buffer_tails(b)
    a, b = state_to_numpy(a), state_to_numpy(b)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("x", "fx", "stop_code", "n_iterations", "n_evals"):
        assert torch.equal(getattr(res, k), getattr(ref, k)), k


def test_multistart_sharded_mesh_matches_unsharded():
    """JAX's ``test_multistart_sharded_mesh_matches_unsharded``: the exact two
    parabolas, 16 Halton starts, max_iter=5, qp_iters=100."""
    assert len(tms.mesh_devices(MESH)) == 4
    mop = tsyn.make_two_parabolas(lb=LB2, ub=UB2)
    ac = mt.AlgorithmConfig(max_iter=5, qp_iters=100)
    x0 = tsyn.halton_starts(16, LB2, UB2)
    res = mt.multistart_optimize(mop, x0, ac, F64, mesh=MESH)
    assert res.x.shape == (16, 2) and torch.isfinite(res.fx).all()
    ref = mt.multistart_optimize(mop, x0, ac, F64, device="cpu")
    _assert_bitwise(res, ref)
    assert (res.stop_code > 1).all()
    assert res.trips == ref.trips


def test_staged_widths_sharded_mesh_match_plain():
    """JAX's ``test_staged_widths_sharded_mesh_match_plain``: per-shard lane
    compaction (widths (16, 8, 8) become (4, 2, 2) a shard) on the main
    path's problem, max_iter=12, equal to the plain unsharded run."""
    mop = tsyn.make_two_parabolas(RbfConfig(kernel="multiquadric"), LB2, UB2)
    ac = mt.AlgorithmConfig(max_iter=12, qp_iters=100)
    x0 = tsyn.halton_starts(16, LB2, UB2)
    ref = mt.multistart_optimize(mop, x0, ac, F64, device="cpu")
    run = mt.StagedMultistart(mop, ac, F64, schedule=(3, 6), widths=(16, 8, 8), mesh=MESH)
    assert [r.widths for r in run._shard_runners.values()] == [(4, 2, 2)]
    _assert_bitwise(run(x0), ref, canonical=True)


def test_staged_multistart_sharded_mesh():
    """JAX's ``test_staged_multistart_sharded_mesh``: the staged runner
    (schedule (2,)) over the mesh equals the unsharded staged run, and the
    runner's ``solve_from_state`` shards a state the same way."""
    mop = tsyn.make_two_parabolas(lb=LB2, ub=UB2)
    ac = mt.AlgorithmConfig(max_iter=6, qp_iters=100)
    x0 = tsyn.halton_starts(16, LB2, UB2)
    sharded = mt.StagedMultistart(mop, ac, F64, schedule=(2,), mesh=MESH)
    ref = mt.StagedMultistart(mop, ac, F64, schedule=(2,), device="cpu")(x0)
    _assert_bitwise(sharded(x0), ref, canonical=True)
    from_state = sharded.solve_from_state(sharded.solver.initialize(x0))
    _assert_bitwise(from_state, ref, canonical=True)


def test_parametric_sharded_mesh_matches_unsharded():
    """``parametric_multistart(mesh=)``: eight centres over four shards,
    each shard's theta with its lanes, equal to the unsharded run."""
    thetas = np.stack([np.full((2,), 0.5 + 0.25 * i) for i in range(8)])
    x0 = tsyn.halton_starts(8, LB2, UB2)
    ac = mt.AlgorithmConfig(max_iter=8, qp_iters=100)
    res = mt.parametric_multistart(tsyn.build_shifted, x0, thetas, ac, F64, mesh=MESH)
    ref = mt.parametric_multistart(tsyn.build_shifted, x0, thetas, ac, F64, device="cpu")
    _assert_bitwise(res, ref)
    assert torch.equal(res.state.theta[0], torch.as_tensor(thetas))


def test_mesh_rejects_a_batch_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        mt.multistart_optimize(tsyn.make_two_parabolas(), np.zeros((6, 2)),
                               mt.AlgorithmConfig(max_iter=2), F64, mesh=MESH)


def test_dryrun_multichip_on_cpu():
    """``dryrun_multichip(4, device="cpu")``: the sharded step and the
    sharded f64 solve against the unsharded one; without four CUDA devices
    and without ``device`` it raises."""
    line = dryrun_multichip(4, device="cpu")
    assert line.startswith("dryrun_multichip(4): ok") and "sharded == unsharded" in line
    if torch.cuda.device_count() < 4:
        with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
            dryrun_multichip(4)
