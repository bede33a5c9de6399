"""Fixed-capacity evaluation database, batched over lanes.

Counterpart of ``morbit_tpu/core/database.py`` (the reference's append-only
``ArrayDB``, ``src/Databases.jl:11-120``). Sites, values and the evaluated
flag are packed into one ``(B, cap, n + m + 1)`` tensor with a per-lane fill
counter; sites are stored in scaled space. Rows are append-only: inserts
touch only the slot at ``count``, and :func:`eval_missing` only fills rows
whose evaluated flag is unset.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Database:
    data: torch.Tensor      # (B, cap, n + m + 1): [sites | values | evaluated]
    count: torch.Tensor     # (B,) int32 fill counter
    # set once an insert was DROPPED because the database was full (the
    # reference ArrayDB is unbounded); the default capacity makes it
    # unreachable
    overflow: torch.Tensor  # (B,) bool
    n: int
    m: int

    @property
    def X(self):
        return self.data[..., : self.n]

    @property
    def Y(self):
        return self.data[..., self.n: self.n + self.m]

    @property
    def evaluated(self):
        return self.data[..., self.n + self.m] > 0.5


def init_database(B: int, cap: int, n: int, m: int, dtype, device) -> Database:
    return Database(
        data=torch.zeros((B, cap, n + m + 1), dtype=dtype, device=device),
        count=torch.zeros((B,), dtype=torch.int32, device=device),
        overflow=torch.zeros((B,), dtype=torch.bool, device=device),
        n=n, m=m)


def valid_mask(db: Database) -> torch.Tensor:
    cap = db.data.shape[-2]
    return torch.arange(cap, device=db.data.device) < db.count[..., None]


def _onehot_write(data, slot, row, ok):
    """Write ``row`` (B, w) at per-lane ``slot`` where ``ok``."""
    cap = data.shape[-2]
    hit = (torch.arange(cap, device=data.device) == slot[..., None]) & ok[..., None]
    return torch.where(hit[..., None], row[..., None, :], data)


def add_evaluated(db: Database, x, y, do_add=None):
    """Insert sites with their values (``put_eval_result_into_db!``,
    ``Databases.jl:390-401``). Returns the db and the per-lane row index
    (-1 where nothing was inserted)."""
    cap = db.data.shape[-2]
    want = (torch.ones_like(db.overflow) if do_add is None else do_add)
    ok = want & (db.count < cap)
    idx = torch.where(ok, db.count, torch.full_like(db.count, -1))
    flag = torch.ones_like(x[..., :1])
    row = torch.cat([x, y, flag], dim=-1)
    data = _onehot_write(db.data, db.count, row, ok)
    count = torch.where(ok, db.count + 1, db.count)
    overflow = db.overflow | (want & (db.count >= cap))
    return dataclasses.replace(db, data=data, count=count,
                               overflow=overflow), idx


def add_site(db: Database, x, do_add):
    """Insert unevaluated sites ``x`` (B, n) where ``do_add`` (``new_result!``,
    ``Databases.jl``); returns the db and the row index (-1 where nothing
    was inserted). Rows are append-only, which the criticality fixpoint
    certificate (``Solver._crit_microstep``) relies on."""
    cap = db.data.shape[-2]
    ok = do_add & (db.count < cap)
    idx = torch.where(ok, db.count, torch.full_like(db.count, -1))
    row = torch.cat([x, x.new_zeros(x.shape[:-1] + (db.m + 1,))], dim=-1)
    data = _onehot_write(db.data, db.count, row, ok)
    count = torch.where(ok, db.count + 1, db.count)
    overflow = db.overflow | (do_add & (db.count >= cap))
    return dataclasses.replace(db, data=data, count=count,
                               overflow=overflow), idx


def add_sites(db: Database, x, do_add):
    """Insert unevaluated sites ``x`` (B, k, n) where ``do_add`` (B, k), in
    index order: the rows and indices that k calls of :func:`add_site`
    give, written in one pass. Returns the db and the (B, k) row indices
    (-1 where nothing was inserted)."""
    cap, k = db.data.shape[-2], x.shape[-2]
    want = do_add.to(torch.int32)
    slot = db.count[:, None] + torch.cumsum(want, -1, dtype=torch.int32) - 1
    ok = do_add & (slot < cap)
    idx = torch.where(ok, slot, torch.full_like(slot, -1))
    # the sites to add, packed to the front in index order
    perm = torch.argsort(1 - want, dim=-1, stable=True)
    packed = torch.gather(x, 1, perm[..., None].expand_as(x))
    rows = torch.cat([packed, x.new_zeros(x.shape[:-1] + (db.m + 1,))], dim=-1)
    n_new = want.sum(-1, dtype=torch.int32)
    src = torch.arange(cap, device=x.device) - db.count[:, None]
    take = (src >= 0) & (src < n_new[:, None])
    src = torch.clamp(src, 0, k - 1)
    new = torch.gather(rows, 1, src[..., None].expand(-1, -1, rows.shape[-1]))
    data = torch.where(take[..., None], new, db.data)
    count = torch.clamp(db.count + n_new, max=cap)
    overflow = db.overflow | (db.count + n_new > cap)
    return dataclasses.replace(db, data=data, count=count, overflow=overflow), idx


def eval_missing(db: Database, eval_fn_scaled: Callable, window: int | None = None,
                 eval_batch_masked: Callable | None = None):
    """Evaluate every unevaluated row in one batched call (``eval_missing!``,
    ``Databases.jl:258-277``). Returns the db and the per-lane number of
    evaluations performed.

    ``window``: static bound on how many trailing rows can be unevaluated
    (rows are append-only and each model update ends with this pass), so
    only that tail is evaluated.

    ``eval_batch_masked(X, missing)``: the evaluation of a group with host
    functions, given the sites and the mask of the missing rows (of the
    window with ``window``), so that user code runs at those rows only."""
    B, cap, _ = db.data.shape
    n, m = db.n, db.m
    if window is None or window >= cap:
        missing = valid_mask(db) & ~db.evaluated
        if eval_batch_masked is not None:
            new_vals = eval_batch_masked(db.X, missing)
        else:
            new_vals = eval_fn_scaled(db.X)               # (B, cap, m)
        new_rows = torch.cat([new_vals, torch.ones_like(new_vals[..., :1])], -1)
        tail = torch.where(missing[..., None], new_rows, db.data[..., n:])
        data = torch.cat([db.data[..., :n], tail], dim=-1)
        return (dataclasses.replace(db, data=data),
                missing.sum(-1, dtype=torch.int32))

    start = torch.clamp(db.count - window, 0, cap - window)
    idx = start[:, None] + torch.arange(window, device=db.data.device)
    Dw = torch.gather(db.data, 1, idx[..., None].expand(B, window, db.data.shape[-1]))
    Xw = Dw[..., :n]
    missing_w = (idx < db.count[:, None]) & (Dw[..., n + m] <= 0.5)
    if eval_batch_masked is not None:
        vals_w = eval_batch_masked(Xw, missing_w)
    else:
        vals_w = eval_fn_scaled(Xw)
    new_rows = torch.cat([Xw, vals_w, torch.ones_like(vals_w[..., :1])], -1)
    Dw_new = torch.where(missing_w[..., None], new_rows, Dw)
    data = db.data.scatter(1, idx[..., None].expand_as(Dw_new), Dw_new)
    return (dataclasses.replace(db, data=data),
            missing_w.sum(-1, dtype=torch.int32))


def results_in_box(db: Database, lb, ub, exclude_index=None):
    """Mask of valid rows inside the per-lane box (``Databases.jl:324-327``),
    optionally excluding one row per lane."""
    X = db.X
    inside = ((X >= lb[..., None, :]) & (X <= ub[..., None, :])).all(-1)
    mask = valid_mask(db) & inside
    if exclude_index is not None:
        cap = X.shape[-2]
        mask = mask & (torch.arange(cap, device=X.device) != exclude_index[..., None])
    return mask


def get_rows(db: Database, idx):
    """Gather (sites, values) for per-lane indices ``idx`` (B, k); idx < 0
    gives zeros."""
    cap, w = db.data.shape[-2:]
    safe = torch.clamp(idx, 0, cap - 1).long()
    rows = torch.gather(db.data, 1, safe[..., None].expand(*safe.shape, w))
    rows = torch.where((idx >= 0)[..., None], rows, torch.zeros_like(rows))
    return rows[..., : db.n], rows[..., db.n: db.n + db.m]


def compact_to_row(db: Database, idx) -> Database:
    """Drop all history but row ``idx`` (B,), moved to row 0, per lane: the
    ``use_db=False`` / ``MockDB`` analogue (``Databases.jl:11-32``). The
    per-iteration working set still needs a buffer, so the database stays
    small and is reset to the current iterate's row each iteration;
    ``idx < 0`` empties a lane's database. Stale rows keep their sites and
    values with the evaluated flag cleared (validity follows the fill
    counter)."""
    cap = db.data.shape[-2]
    keep = idx >= 0
    flag = db.n + db.m
    safe = torch.clamp(idx, 0, cap - 1).long()
    row = torch.gather(db.data, 1, safe[:, None, None].expand(-1, 1, db.data.shape[-1]))
    row = row.clone()
    row[..., flag] = torch.where(keep[:, None], row[..., flag], torch.zeros_like(row[..., flag]))
    data = db.data.clone()
    data[:, 1:, flag] = 0.0
    data[:, :1] = row
    count = torch.where(keep, torch.ones_like(db.count), torch.zeros_like(db.count))
    return dataclasses.replace(db, data=data, count=count)


def rescale(db: Database, old_scale, old_offset, new_scale, new_offset) -> Database:
    """Re-transform the stored sites of the valid rows when the variable
    scaler changes (``transform!``/``untransform!``, ``Databases.jl``,
    ``algorithm.jl:661-679``); scalers are ``(B, n)`` or ``(n,)``. Rows at
    or past the fill counter keep their bits."""
    lane = lambda v: v[..., None, :]
    X = db.X
    X_new = (X - lane(old_offset)) / lane(old_scale) * lane(new_scale) + lane(new_offset)
    X_sel = torch.where(valid_mask(db)[..., None], X_new, X)
    return dataclasses.replace(db, data=torch.cat([X_sel, db.data[..., db.n:]], dim=-1))
