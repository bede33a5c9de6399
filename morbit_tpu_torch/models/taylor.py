"""Taylor polynomial surrogates (degree 1/2), batched over lanes.

Counterpart of ``morbit_tpu/models/taylor.py`` (reference
``src/models/TaylorModel.jl``). Two ways to the derivatives:

* ``mode='callback'``: gradients and Hessians from the user's callbacks or
  autodiff at the unscaled iterate, pulled back to scaled space by the
  unscaling Jacobian (``TaylorModel.jl:293-360``);
* ``mode='fd'``: finite differences through the evaluation database
  (``TaylorModel.jl:163-276``). The stamps of the reference's recursion
  (``RecursiveFiniteDifferences.jl``) are compiled once into flat
  coefficient tables over the stencil's sites, so the fit is two
  contractions::

      g = G @ Y / h                         (m, n)
      H = einsum('ijs,sm->mij', H_c, Y) / h^2

  Stencil sites are projected into the scaled box (``TaylorModel.jl:190``).

Model: ``m_l(x) = f_l(x0) + g_l' d + 0.5 d' H_l d`` with ``d = x - x0``
(``TaylorModel.jl:372-408``); always fully linear (``TaylorModel.jl:45``).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from morbit_tpu_torch.core import database as dbm
from morbit_tpu_torch.core import scaling
from morbit_tpu_torch.models.base import ModelContext, SurrogateOps
from morbit_tpu_torch.ops.batched_linalg import lane_contract, lane_product
from morbit_tpu_torch.ops.geometry import project_into_box

# First-order stamps: (grid, coefficients), derivative ~ sum c_a f(x + h g_a e_i) / h
# (``RecursiveFiniteDifferences.jl:55-182``: CFDStamp(1, acc), FFDStamp(1, acc),
# BFDStamp(1, acc))
STAMPS = {
    "cfd1": (np.array([-1, 0, 1]), np.array([-0.5, 0.0, 0.5])),            # CFD(1,2)
    "cfd1_4": (np.arange(-2, 3),
               np.array([1 / 12, -2 / 3, 0.0, 2 / 3, -1 / 12])),           # CFD(1,4)
    "cfd1_6": (np.arange(-3, 4),
               np.array([-1 / 60, 3 / 20, -3 / 4, 0.0, 3 / 4, -3 / 20, 1 / 60])),  # CFD(1,6)
    "ffd1": (np.array([0, 1]), np.array([-1.0, 1.0])),                     # FFD(1,1)
    "ffd1_2": (np.array([0, 1, 2]), np.array([-1.5, 2.0, -0.5])),          # FFD(1,2)
    "ffd1_3": (np.array([0, 1, 2, 3]),
               np.array([-11 / 6, 3.0, -1.5, 1 / 3])),                     # FFD(1,3)
    "bfd1": (np.array([0, -1]), np.array([1.0, -1.0])),                    # BFD(1,1)
    "bfd1_2": (np.array([0, -1, -2]), np.array([1.5, -2.0, 0.5])),         # BFD(1,2)
    "bfd1_3": (np.array([0, -1, -2, -3]),
               np.array([11 / 6, -3.0, 1.5, -1 / 3])),                     # BFD(1,3)
}

# Direct second-derivative stamps for the Hessian diagonal (beyond the
# reference, whose recursion builds order-1 stamps only): d2f/dx_i^2 ~
# sum c_a f(x + h g_a e_i) / h^2; mixed partials keep the order-1 recursion.
STAMPS2 = {
    "cfd2": (np.array([-1, 0, 1]), np.array([1.0, -2.0, 1.0])),           # CFD(2,2)
    "cfd2_4": (np.arange(-2, 3),
               np.array([-1 / 12, 4 / 3, -5 / 2, 4 / 3, -1 / 12])),       # CFD(2,4)
}


def _build_stencil(n: int, degree: int, stamp: str, hess_stamp: str = "compose"):
    """Static stencil: unique integer offset rows O (S, n), the centre
    first; gradient coefficients G (n, S); Hessian coefficients H (n, n, S)
    (None at degree 1). The Hessian is the finite difference of the finite
    difference, H_ij = sum_a sum_b c_a c_b f(x + h (g_a e_i + g_b e_j)),
    unless ``hess_stamp`` names a direct stamp for the diagonal."""
    grid, coef = STAMPS[stamp]
    offsets = {}

    def site_id(off):
        key = tuple(off)
        if key not in offsets:
            offsets[key] = len(offsets)
        return offsets[key]

    site_id((0,) * n)

    G_entries = []
    for i in range(n):
        for a, ca in zip(grid, coef):
            if ca == 0.0:
                continue
            off = [0] * n
            off[i] = int(a)
            G_entries.append((i, site_id(off), ca))

    H_entries = []
    if degree >= 2:
        direct = hess_stamp != "compose"
        if direct:
            grid2, coef2 = STAMPS2[hess_stamp]
        for i in range(n):
            for j in range(n):
                if direct and i == j:
                    for a, ca in zip(grid2, coef2):
                        if ca == 0.0:
                            continue
                        off = [0] * n
                        off[i] = int(a)
                        H_entries.append((i, i, site_id(off), ca))
                    continue
                for (a, ca), (b, cb) in itertools.product(zip(grid, coef), repeat=2):
                    c = ca * cb
                    if c == 0.0:
                        continue
                    off = [0] * n
                    off[i] += int(a)
                    off[j] += int(b)
                    H_entries.append((i, j, site_id(off), c))

    S = len(offsets)
    O = np.zeros((S, n))
    for key, s in offsets.items():
        O[s] = key
    G = np.zeros((n, S))
    for i, s, c in G_entries:
        G[i, s] += c
    H = None
    if degree >= 2:
        H = np.zeros((n, n, S))
        for i, j, s, c in H_entries:
            H[i, j, s] += c
    return O, G, H


class TaylorState(NamedTuple):
    x0: torch.Tensor        # (B, n) scaled expansion point (NaN before the first fit)
    fx0: torch.Tensor       # (B, m)
    g: torch.Tensor         # (B, m, n) gradients in scaled coordinates
    H: torch.Tensor         # (B, m, n, n) Hessians (zeros at degree 1)
    site_idx: torch.Tensor  # (B, S) int32 db rows of the stencil sites (fd; else (B, 1))


class TaylorOps(SurrogateOps):
    def __init__(self, group, n_vars, dtype, ac):
        super().__init__(group, n_vars, dtype, ac)
        cfg = self.cfg
        self.degree = cfg.degree
        self.n_sites = 1
        self._consts = {}
        if cfg.mode == "fd":
            self.O, self.G, self.Hc = _build_stencil(n_vars, cfg.degree, cfg.fd_stamp,
                                                     cfg.hess_stamp)
            self.n_sites = self.O.shape[0]
            self.h = cfg.fd_stepsize
            self.eval_window = self.n_sites

    def init_state(self, B: int, device):
        n, m, dt = self.n_vars, self.group.m, self.dtype
        z = lambda *s: torch.zeros((B,) + s, dtype=dt, device=device)
        return TaylorState(x0=torch.full((B, n), float("nan"), dtype=dt, device=device),
                           fx0=z(m), g=z(m, n), H=z(m, n, n),
                           site_idx=torch.zeros((B, self.n_sites), dtype=torch.int32,
                                                device=device))

    def _const(self, name, device):
        """The stencil table ``O``, ``G`` or ``Hc`` on ``device``, copied
        there once."""
        key = (name, device)
        if key not in self._consts:
            self._consts[key] = torch.as_tensor(getattr(self, name), dtype=self.dtype,
                                                device=device)
        return self._consts[key]

    @staticmethod
    def _moved(state, x):
        return ~(x == state.x0).all(-1)

    # -- phase 1 --------------------------------------------------------------
    def prepare(self, state, db, ctx: ModelContext, ensure_fully_linear):
        """Add the stencil's S-1 sites around x where the iterate moved
        (the reference rebuilds only then, ``TaylorModel.jl``
        ``update_model``), in one batched write."""
        if self.cfg.mode != "fd":
            return state, db
        sites = ctx.x_s[:, None, :] + self.h * self._const("O", ctx.x_s.device)[1:]
        sites = project_into_box(sites, ctx.scal.lb_scaled[:, None, :],
                                 ctx.scal.ub_scaled[:, None, :])
        moved = self._moved(state, ctx.x_s)
        db, new_idx = dbm.add_sites(db, sites, moved[:, None].expand(-1, self.n_sites - 1))
        idx = torch.cat([ctx.x_index[:, None].to(torch.int32), new_idx], dim=-1)
        return state._replace(site_idx=torch.where(moved[:, None], idx, state.site_idx)), db

    # -- phase 2 --------------------------------------------------------------
    def fit(self, state, db, ctx: ModelContext):
        x = ctx.x_s
        moved = self._moved(state, x)
        fx0 = dbm.get_rows(db, ctx.x_index[:, None])[1][:, 0]
        if self.cfg.mode == "fd":
            _, Y = dbm.get_rows(db, state.site_idx)                  # (B, S, m)
            h = torch.tensor(self.h, dtype=self.dtype)
            g = lane_contract(self._const("G", x.device), Y) / h
            if self.degree >= 2:
                H = lane_contract(self._const("Hc", x.device), Y) / h ** 2
            else:
                H = torch.zeros_like(state.H)
        else:
            xu = scaling.untransform(ctx.scal, x)
            inv_s = 1.0 / ctx.scal.scale                              # (B, n)
            g = self.group.jac_unscaled(xu) * inv_s[:, None, :]
            if self.degree >= 2:
                H = (self.group.hess_unscaled(xu) * inv_s[:, None, :, None]
                     * inv_s[:, None, None, :])
            else:
                H = torch.zeros_like(state.H)
        keep = lambda new, old: torch.where(
            moved.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)
        return TaylorState(x0=keep(x, state.x0), fx0=keep(fx0, state.fx0),
                           g=keep(g, state.g), H=keep(H, state.H),
                           site_idx=state.site_idx)

    # -- evaluation ------------------------------------------------------------
    def eval(self, state, x_s, scal=None):
        """Model values at sites ``x_s (B, ..., n)`` -> ``(B, ..., m)``."""
        extra = x_s.dim() - 2
        lead = lambda t: t.reshape(t.shape[:1] + (1,) * extra + t.shape[1:])
        d = x_s - lead(state.x0)
        out = lead(state.fx0) + lane_product(lead(state.g), d[..., None])[..., 0]
        if self.degree >= 2:
            Hd = lane_product(lead(state.H), d[..., None, :, None])[..., 0]  # (B, ..., m, n)
            out = out + 0.5 * (Hd * d[..., None, :]).sum(-1)
        return out

    def jac(self, state, x_s, scal=None):
        """(B, m, n) model Jacobians at one site per lane: g + 0.5 (H + H') d
        (``TaylorModel.jl`` ``get_gradient``)."""
        if self.degree >= 2:
            d = x_s - state.x0
            Hs = state.H + state.H.transpose(-1, -2)
            return state.g + 0.5 * lane_product(Hs, d[:, None, :, None])[..., 0]
        return state.g

    def fully_linear(self, state):
        return True
