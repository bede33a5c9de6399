"""Carry a configuration and a solver state over from the JAX package.

The port imports nothing of the JAX package, so both cross as plain data:

* :func:`config_from_dict` takes ``dataclasses.asdict`` of the JAX
  ``AlgorithmConfig``;
* :func:`state_from_numpy` takes a JAX ``SolverState`` as a dict of numpy
  arrays, leaf name to array: ``x``, ``x_s``, ``fx``, the constraint values
  ``l_e``, ``l_i``, ``c_e``, ``c_i``, ``dlt``, ``ints``,
  ``traj.data``, ``traj.count``, ``scal.<field>`` (scale, offset,
  lb_scaled, ub_scaled), ``filter.<field>`` (theta, fvals, count,
  overflow), ``groups.<i>.db.<field>`` (data, count, overflow) and
  ``groups.<i>.n_evals``, and for an RBF group its model in the JAX
  package's packed layout: ``groups.<i>.model.meta`` (``[idx (cap_train) |
  n_train | fully_linear | dirs_head | dirs_count]``),
  ``groups.<i>.model.dirs``, ``groups.<i>.model.fit.fdata`` (``[sites | w |
  mask]``) and ``groups.<i>.model.fit.flam`` (``[lam ; param row]``); for
  a Taylor group ``groups.<i>.model.<field>`` of ``x0``, ``fx0``, ``g``,
  ``H``, ``site_idx``, and for a Lagrange group of ``B``, ``coef``,
  ``idx``, ``lb``, ``ub``, ``fully_linear`` (the JAX states' own fields). A
  state without a lane axis (one ``optimize`` run) gets one. The filter
  crosses with its entries (a dummy filter has capacity 0). The PRNG key
  ``key`` (uint32 words) crosses when the dict has it, and the port's
  state has one only when a group draws random numbers
  (``RbfConfig(use_max_points=True)``). A parametric problem's per-lane data
crosses as ``theta.<i>``, its leaves in order, each in its own dtype.
States of runs with composites (an inner
  function's group is an ordinary group) and with the ``'model'`` scaler
  update (each lane's scaler is a leaf) cross as they are.

:func:`state_to_numpy` produces the same dict from the port's state, so two
states compare leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from morbit_tpu_torch.core import filter as flt
from morbit_tpu_torch.core import scaling
from morbit_tpu_torch.core.algorithm import (SolverState, TrajectoryState,
                                              resolve_device)
from morbit_tpu_torch.core.config import AlgorithmConfig
from morbit_tpu_torch.core.database import Database
from morbit_tpu_torch.core.descent import resolve_descent_config
from morbit_tpu_torch.models.container import GroupState
from morbit_tpu_torch.models.lagrange import LagrangeState
from morbit_tpu_torch.models.rbf_model import RbfState
from morbit_tpu_torch.models.taylor import TaylorState
from morbit_tpu_torch.ops.rbf import RbfFit

#: the leaves of the families whose state crosses field by field, with the
#: integer and boolean fields' types
_FIELD_STATES = ((TaylorState, {"site_idx": torch.int32}),
                 (LagrangeState, {"idx": torch.int32, "fully_linear": torch.bool}))

def config_from_dict(d: dict) -> AlgorithmConfig:
    """The port's ``AlgorithmConfig`` from ``dataclasses.asdict`` of the JAX
    one (a descent config object arrives as a dict of its fields)."""
    d = dict(d)
    if isinstance(d.get("descent_method"), dict):
        d["descent_method"] = resolve_descent_config(d["descent_method"])
    return AlgorithmConfig(**d)


def state_from_numpy(leaves: dict, device=None, dtype=None) -> SolverState:
    """Build the port's batched state from a dict of numpy leaves, on CUDA
    unless ``device`` says otherwise (the solvers' default, so that a
    carried state reaches the kernels)."""
    device = resolve_device(device)
    batched = np.asarray(leaves["x"]).ndim == 2
    dtype = dtype or torch.from_numpy(np.array(leaves["x"])).dtype

    def t(name, kind=None):
        a = np.array(leaves[name])  # a writable copy
        if not batched:
            a = a[None]
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.as_tensor(a, dtype=kind or dtype, device=device)

    x = t("x")
    n = x.shape[-1]
    fx = t("fx")
    m = fx.shape[-1]
    traj = t("traj.data")
    ints = t("ints", torch.int32)
    G = ints.shape[-1] - 5
    groups = []
    for i in range(G):
        data = t(f"groups.{i}.db.data")
        model = ()
        pre = f"groups.{i}.model."
        if pre + "meta" in leaves:
            model = _rbf_from_packed(t(pre + "meta", torch.int32), t(pre + "dirs"),
                                     t(pre + "fit.fdata"), t(pre + "fit.flam"), n)
        for kind, kinds in _FIELD_STATES:
            if all(pre + f in leaves for f in kind._fields):
                model = kind(*(t(pre + f, kinds.get(f)) for f in kind._fields))
        groups.append(GroupState(
            db=Database(data=data, count=t(f"groups.{i}.db.count", torch.int32),
                        overflow=t(f"groups.{i}.db.overflow", torch.bool),
                        n=n, m=data.shape[-1] - n - 1),
            model=model, n_evals=t(f"groups.{i}.n_evals", torch.int32)))
    return SolverState(
        x=x, x_s=t("x_s"), fx=fx, l_e=t("l_e"), l_i=t("l_i"), c_e=t("c_e"),
        c_i=t("c_i"), dlt=t("dlt"), ints=ints,
        groups=tuple(groups),
        filter=flt.FilterState(theta=t("filter.theta"),
                               fvals=t("filter.fvals"),
                               count=t("filter.count", torch.int32),
                               overflow=t("filter.overflow", torch.bool)),
        traj=TrajectoryState(data=traj, count=t("traj.count", torch.int32),
                             n=n, m=m, G=G, MW=traj.shape[-1] - (n + m + 5 + G)),
        scal=scaling.VarScaler(*(t(f"scal.{f}") for f in scaling.VarScaler._fields)),
        key=t("key", torch.int64) if "key" in leaves else None,
        theta=tuple(torch.as_tensor(np.array(leaves[f"theta.{i}"]), device=device)
                    for i in range(sum(k.startswith("theta.") for k in leaves))))


def state_to_numpy(state: SolverState) -> dict:
    """The port's state as a dict of numpy leaves, named as above."""
    host = lambda v: v.detach().cpu().numpy()
    out = {f: host(getattr(state, f))
           for f in ("x", "x_s", "fx", "l_e", "l_i", "c_e", "c_i", "dlt", "ints")}
    out["traj.data"] = host(state.traj.data)
    out["traj.count"] = host(state.traj.count)
    for f in scaling.VarScaler._fields:
        out[f"scal.{f}"] = host(getattr(state.scal, f))
    for f in flt.FilterState._fields:
        out[f"filter.{f}"] = host(getattr(state.filter, f))
    if state.key is not None:
        out["key"] = host(state.key).astype(np.uint32)
    for i, leaf in enumerate(state.theta):
        out[f"theta.{i}"] = host(leaf)
    for i, g in enumerate(state.groups):
        for f in ("data", "count", "overflow"):
            out[f"groups.{i}.db.{f}"] = host(getattr(g.db, f))
        out[f"groups.{i}.n_evals"] = host(g.n_evals)
        if isinstance(g.model, (TaylorState, LagrangeState)):
            for f in g.model._fields:
                out[f"groups.{i}.model.{f}"] = host(getattr(g.model, f))
        if isinstance(g.model, RbfState):
            meta, dirs, fdata, flam = _rbf_to_packed(g.model)
            out[f"groups.{i}.model.meta"] = host(meta)
            out[f"groups.{i}.model.dirs"] = host(dirs)
            out[f"groups.{i}.model.fit.fdata"] = host(fdata)
            out[f"groups.{i}.model.fit.flam"] = host(flam)
    return out


def _rbf_from_packed(meta, dirs, fdata, flam, n) -> RbfState:
    cap = meta.shape[-1] - 4
    m = fdata.shape[-1] - n - 1
    return RbfState(
        idx=meta[:, :cap].contiguous(), n_train=meta[:, cap].contiguous(),
        fully_linear=meta[:, cap + 1] > 0, dirs_head=meta[:, cap + 2].contiguous(),
        dirs_count=meta[:, cap + 3].contiguous(), dirs=dirs,
        fit=RbfFit(sites=fdata[..., :n].contiguous(),
                   mask=fdata[..., n + m] > 0.5,
                   w=fdata[..., n:n + m].contiguous(),
                   lam=flam[:, :-1].contiguous(), param=flam[:, -1, 0].contiguous()))


def _rbf_to_packed(st: RbfState):
    i32 = torch.int32
    meta = torch.cat([st.idx, st.n_train[:, None], st.fully_linear.to(i32)[:, None],
                      st.dirs_head[:, None], st.dirs_count[:, None]], dim=-1).to(i32)
    f = st.fit
    fdata = torch.cat([f.sites, f.w, f.mask.to(f.sites.dtype)[..., None]], dim=-1)
    prow = f.param[:, None, None].expand(-1, 1, f.w.shape[-1])
    flam = torch.cat([f.lam, prow], dim=-2)
    return meta, st.dirs, fdata, flam
