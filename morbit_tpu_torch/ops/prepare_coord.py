"""RBF training-site rounds 1-3, batched over lanes (plain twin of K2).

Counterpart of ``rbf_selection_core`` (``morbit_tpu/models/rbf_model.py:
130-254``), whose TPU kernel body is ``morbit_tpu/ops/prepare_coord.py``.
:func:`rbf_selection_core` here is the batched plain version of the CUDA
kernel K2 (``morbit_tpu_torch/csrc/rbf_selection.cu``):

* round 1 (``RbfModel.jl:242-248``): affinely independent database points
  in the ``theta_1 * Delta`` box;
* round 2 (``:251-265``): the same in the ``theta_2 * Delta_max`` box, warm
  started from round 1's span, skipped when nothing is missing or when the
  two boxes coincide (``:588``);
* round 3 (``:269-307``): sites along the improving directions, with the
  coordinate-axis rebuild (``:633-637``) when a pivot fails under
  ensure-fully-linear.

The ensure-fully-linear flag is per lane (``efl``). The JAX package's
traced-flag variant computes round 2 and both round-3 proposals and selects
per the flag; its values equal those of the static variants
(``rbf_model.py:146-153``), so this one variant serves initialization
(flag set on every lane) and every trip.
"""

from __future__ import annotations

import torch

from morbit_tpu_torch.ops.affine import (affinely_independent_points,
                                         improving_directions_from)
from morbit_tpu_torch.ops.geometry import intersect_box

#: ``jnp.isclose`` / ``torch.isclose`` defaults, used by the round-2 skip test
ISCLOSE_RTOL, ISCLOSE_ATOL = 1e-5, 1e-8


def isclose(a: torch.Tensor, b: float) -> torch.Tensor:
    """``jnp.isclose(a, b)`` with its formula and default tolerances, in
    ``a``'s dtype."""
    dt = a.dtype
    bt = torch.tensor(b, dtype=dt, device=a.device)
    atol = torch.tensor(ISCLOSE_ATOL, dtype=dt, device=a.device)
    rtol = torch.tensor(ISCLOSE_RTOL, dtype=dt, device=a.device)
    return (a == bt) | (torch.isfinite(bt) & ((a - bt).abs() <= atol + rtol * bt.abs()))


def round3_proposal(x_s, dirs, n_missing, max_new, lb1, ub1, piv1):
    """Round-3 sites along the direction rows of ``dirs`` (B, n, n)
    (``RbfModel.jl:269-307``). Returns (sites (B, n, n), active, ok (B, n),
    any_fail, covers (B,), n_new (B,))."""
    n = x_s.shape[-1]
    n_new = torch.clamp(n_missing, min=0)
    n_new = torch.minimum(n_new, torch.clamp(max_new, min=0)).to(torch.int32)
    xb = x_s[:, None, :].expand_as(dirs)
    ln = intersect_box(xb, dirs, lb1[:, None, :].expand_as(dirs),
                       ub1[:, None, :].expand_as(dirs), ret_mode="absmax")
    offset = ln[..., None] * dirs
    ok = offset.abs().amax(-1) > piv1[:, None]
    active = torch.arange(n, device=x_s.device)[None, :] < n_new[:, None]
    any_fail = (active & ~ok).any(-1)
    covers = n_new >= n_missing
    return xb + offset, active, ok, any_fail, covers, n_new


def rbf_selection_core(X, count, x_s, x_index, delta, lb_s, ub_s, max_new, efl,
                       *, theta_e1, theta_e2_dmax, theta_pivot, delta_max,
                       skip2_same_theta):
    """Rounds 1-3 selection for every lane.

    ``X`` (B, cap, n) database sites, ``count``/``x_index``/``max_new`` (B,)
    int, ``x_s``/``lb_s``/``ub_s`` (B, n), ``delta`` (B,), ``efl`` (B,) bool.
    Returns (r1_idx, r1_cnt, r2_idx, r2_cnt, sites3, active3, n_new, dirs,
    dirs_count, fully_linear), as ``rbf_selection_core`` of the JAX
    package."""
    B, cap, n = X.shape
    dt, dev = X.dtype, X.device
    i32 = torch.int32
    delta_1 = torch.tensor(theta_e1, dtype=dt, device=dev) * delta
    lb1 = torch.maximum(lb_s, x_s - delta_1[:, None])
    ub1 = torch.minimum(ub_s, x_s + delta_1[:, None])
    piv1 = torch.tensor(theta_pivot, dtype=dt, device=dev) * delta_1

    rows = torch.arange(cap, device=dev)[None, :]
    valid = rows < count[:, None]
    not_center = rows != x_index[:, None]
    in1 = ((X >= lb1[:, None, :]) & (X <= ub1[:, None, :])).all(-1)
    cand1 = valid & in1 & not_center

    # ---- round 1
    sel1 = affinely_independent_points(x_s, X, cand1, piv1,
                                       torch.full((B,), n, dtype=i32, device=dev))
    dirs, dirs_count = improving_directions_from(sel1.Z, sel1.k)
    r1_idx, r1_cnt = sel1.order, sel1.n_picked
    n_missing1 = n - r1_cnt

    # ---- round 2, masked where the flag is set
    delta_2 = torch.tensor(theta_e2_dmax, dtype=dt, device=dev)
    lb2 = torch.maximum(lb_s, x_s - delta_2)
    ub2 = torch.minimum(ub_s, x_s + delta_2)
    in2 = ((X >= lb2[:, None, :]) & (X <= ub2[:, None, :])).all(-1)
    cand2 = valid & in2 & not_center & ~cand1
    sel2 = affinely_independent_points(x_s, X, cand2, piv1, n_missing1,
                                       Y_init=sel1.Y, k_init=sel1.k)
    skip2 = n_missing1 == 0
    if skip2_same_theta:
        skip2 = skip2 | isclose(delta, delta_max)
    r2_cnt = torch.where(skip2 | efl, 0, sel2.n_picked).to(i32)
    r2_idx = torch.where(efl[:, None], -1, sel2.order).to(i32)
    fl_after2 = efl | skip2
    n_missing2 = n_missing1 - r2_cnt

    # ---- round 3: the normal proposal and the coordinate-axis rebuild
    s3, act3, ok3, fail3, covers3, n_new3 = round3_proposal(
        x_s, dirs, n_missing2, max_new, lb1, ub1, piv1)
    dirs_cb = torch.eye(n, dtype=dt, device=dev).expand(B, n, n)
    full = torch.full((B,), n, dtype=i32, device=dev)
    s3c, act3c, ok3c, _, covers3c, n_new3c = round3_proposal(
        x_s, dirs_cb, full, max_new, lb1, ub1, piv1)

    rebuild = efl & fail3
    r1_cnt = torch.where(rebuild, 0, r1_cnt).to(i32)
    r2_cnt = torch.where(rebuild, 0, r2_cnt).to(i32)
    sites3 = torch.where(rebuild[:, None, None], s3c, s3)
    active3 = torch.where(rebuild[:, None], act3c, act3)
    ok3 = torch.where(rebuild[:, None], ok3c, ok3)
    n_new = torch.where(rebuild, n_new3c, n_new3).to(i32)
    dirs = torch.where(rebuild[:, None, None], dirs_cb, dirs)
    dirs_count = torch.where(rebuild, n, dirs_count).to(i32)
    round3_ran = rebuild | (n_missing2 > 0)
    fl3 = torch.where(rebuild, covers3c, covers3) & (ok3 | ~active3).all(-1)
    fully_linear = ((round3_ran & fl3 & (r2_cnt == 0))
                    | (~round3_ran & fl_after2))
    return (r1_idx, r1_cnt, r2_idx, r2_cnt, sites3, active3, n_new, dirs,
            dirs_count, fully_linear)
