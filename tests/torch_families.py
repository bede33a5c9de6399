"""Shared pieces of the Taylor, Lagrange and Pascoletti-Serafini port tests
(``tests/test_torch_taylor.py``, ``test_torch_lagrange.py``,
``test_torch_ps.py``): the two-parabolas problem for both packages, the
oracle comparison, and the batch checks every family runs."""

import jax.numpy as jnp
import numpy as np
import torch

import morbit_tpu_torch as mt
import morbit_tpu_torch.parallel.multistart as tms
import morbit_tpu_torch.problems.synthetic as tsyn
from morbit_tpu.core.mop import MOP as JaxMOP
from morbit_tpu_torch.utils.logging import trajectory_arrays
from tests.oracle_full import GroupSpec, solve_oracle_full
from tests.test_oracle_full_parity import _assert_parity
from tests.test_torch_multistart import _assert_lanes_equal

F64 = torch.float64
LB2, UB2 = [-4.0, -4.0], [4.0, 4.0]
X0 = np.array([-3.0, 2.5])
GOLDEN_X0 = [-3.141592653589793, 2.71828]


def parabolas(cfg=None, port=True, exact=False):
    """Two parabolas on [-4, 4]^2: both objectives on ``cfg``, or each exact."""
    mop, s = (mt.MOP(LB2, UB2), torch) if port else (JaxMOP(LB2, UB2), jnp)
    for c in (1.0, -1.0):
        f = lambda x, c=c: s.sum((x - c) ** 2)
        if exact:
            mop.add_exact_objective(f)
        else:
            mop.add_objective(f, model_cfg=cfg)
    return mop


def oracle_groups(kind=None, exact=False, **spec):
    """The oracle's groups of :func:`parabolas`."""
    F = lambda x: np.array([np.sum((x - 1.0) ** 2), np.sum((x + 1.0) ** 2)])
    J = lambda x: np.stack([2.0 * (x - 1.0), 2.0 * (x + 1.0)])
    if exact:
        return [GroupSpec(role="obj", m=1, F=lambda x, k=k: F(x)[k:k + 1],
                          J=lambda x, k=k: J(x)[k:k + 1]) for k in (0, 1)]
    return [GroupSpec(role="obj", m=2, F=F, J=J, kind=kind, **spec)]


def assert_matches_oracle(cfg, groups, tol, okw=(), exact=False, **kw):
    """``optimize`` against the full oracle: structure exact, floats within
    ``tol`` (``tests/test_oracle_full_parity.py``'s assertions)."""
    res = mt.optimize(parabolas(cfg, exact=exact), X0, device="cpu", dtype=F64, **kw)
    kw.pop("descent_method", None)
    orc = solve_oracle_full(LB2, UB2, groups, X0, **kw, **dict(okw))
    _assert_parity(res, orc, tol)
    return res


def lane_record(res, lane=None):
    """Structure and trajectory of one lane of a result (``lane=None``: an
    ``optimize`` result)."""
    pick = (lambda t: t) if lane is None else (lambda t: t[lane])
    tr = trajectory_arrays(res, lane)
    return dict(stop_code=int(pick(res.stop_code)), n_iterations=int(pick(res.n_iterations)),
                n_evals=[int(pick(g.n_evals)) for g in res.state.groups],
                it_stat=tr["it_stat"].tolist(), x_indices=tr["x_indices"].tolist(),
                x=tr["x"], fx=tr["fx"], x_final=pick(res.x).numpy())


def assert_records_equal(a, b, tol):
    for k in ("stop_code", "n_iterations", "n_evals", "it_stat", "x_indices"):
        assert a[k] == b[k], (k, a[k], b[k])
    for k in ("x", "fx", "x_final"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol, err_msg=k)


def assert_batch_equals_singles_and_staged(cfg, ac, B=4, start_index=3, **mop_kw):
    """A B-lane ``multistart_optimize`` equals the port's B single runs lane
    by lane, and ``StagedMultistart`` (two capacity stages, compacted
    widths) equals the plain batch leaf by leaf. Returns the batch."""
    x0 = tsyn.halton_starts(B, LB2, UB2, start_index=start_index)
    mop = lambda: parabolas(cfg, **mop_kw)
    batch = mt.multistart_optimize(mop(), x0, ac, dtype=F64, device="cpu")
    for i in range(B):
        one = mt.optimize(mop(), x0[i], ac, dtype=F64, device="cpu")
        assert_records_equal(lane_record(batch, i), lane_record(one), 1e-12)
    staged = tms.StagedMultistart(mop(), ac, F64, schedule=(2, 4), widths=(B, B // 2),
                                  device="cpu")
    assert staged.schedule[0][1][0] < staged.solver.db_capacity
    _assert_lanes_equal(staged(x0), batch, 1e-12)
    return batch
