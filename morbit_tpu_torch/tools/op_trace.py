"""Op by op, where two runs of one solver trip first differ.

:func:`tracing` records, for every torch call a trip makes, lane slices of
its tensor inputs and of its (first) output, keyed by the line of the
package that made the call, the call's name and its count at that line.
The port's device dispatchers (:data:`ATOMIC`: the K1-K7 wrappers and the
float64 solves and products that route by device) count as one call each,
so that a card run and a CPU run, which take different paths inside them,
still line up call for call. :func:`compare` then gives, for every call the
two logs share, the relative gap of one lane's inputs and of its output;
a call whose output parts more than its inputs is where a gap is made or
grown.

Used by ``width_gaps.py`` (one device, two batch widths) and
``card_cpu_gaps.py`` (the card against the CPU).
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import sys

import torch

#: (module, function) of the port that count as one call each
ATOMIC = (
    ("morbit_tpu_torch.ops.batched_linalg", "solve_small"),
    ("morbit_tpu_torch.ops.batched_linalg", "lane_matmul"),
    ("morbit_tpu_torch.ops.batched_linalg", "lane_product"),
    ("morbit_tpu_torch.ops.batched_linalg", "lane_sum"),
    ("morbit_tpu_torch.ops.batched_linalg", "lane_contract"),
    ("morbit_tpu_torch.ops.prepare_fused", "selection"),
    ("morbit_tpu_torch.ops.prepare_fused", "round4"),
    ("morbit_tpu_torch.ops.dense_kernels", "rbf_gram_matrix"),
    ("morbit_tpu_torch.ops.qp_lane", "admm_stages"),
    ("morbit_tpu_torch.ops.qp_lane", "admm_stages_exit"),
)
#: factories the kernels fill: their outputs say nothing
SKIP = ("empty", "empty_like", "new_empty", "empty_strided")


def _caller() -> str:
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if "morbit_tpu_torch" in fn and "/tools/" not in fn:
            return f"{fn.split('morbit_tpu_torch/')[-1]}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


class OpLog(torch.overrides.TorchFunctionMode):
    """The calls of one traced run: ``entries`` maps (line, name, count)
    to (input slices, output slice), in call order. A slice is
    ``t[lanes]`` of a tensor whose first axis is the batch's ``width``,
    else None."""

    def __init__(self, width: int, lanes):
        super().__init__()
        self.width, self.lanes = width, lanes
        self.entries = {}
        self.depth = 0
        self._seen = collections.Counter()

    def _slice(self, t):
        if (isinstance(t, torch.Tensor) and t.dim() and t.shape[0] == self.width
                and not torch._C._functorch.is_functorch_wrapped_tensor(t)):
            return t[self.lanes].detach().cpu().clone()
        return None

    def record(self, name, caller, args, kwargs, out):
        self.depth += 1                 # the slicing below is not traced
        try:
            key = (caller, name)
            n = self._seen[key]
            self._seen[key] += 1
            ins = [self._slice(t) for t in _tensors((args, kwargs or {}))]
            first = next(_tensors(out), None)
            self.entries[(caller, name, n)] = (ins, self._slice(first))
        finally:
            self.depth -= 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", str(func))
        if self.depth == 0 and name not in SKIP:
            self.record(name, _caller(), args, kwargs, out)
        return out


@contextlib.contextmanager
def tracing(width: int, lanes):
    """An :class:`OpLog` of the calls made inside the block, with every
    function of :data:`ATOMIC` (wherever the package imported it) logged as
    one call."""
    log = OpLog(width, lanes)
    originals = {}
    for mod_name, fn_name in ATOMIC:
        fn = getattr(importlib.import_module(mod_name), fn_name, None)
        if fn is not None:
            originals[fn] = _atomic(log, fn)
    patched = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith("morbit_tpu_torch") or mod is None:
            continue
        for attr, val in list(vars(mod).items()):
            if callable(val) and val in originals:
                patched.append((mod, attr, val))
                setattr(mod, attr, originals[val])
    try:
        with log:
            yield log
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)


def _atomic(log, fn):
    def call(*args, **kwargs):
        caller = _caller()
        log.depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            log.depth -= 1
        if log.depth == 0:
            log.record(fn.__name__, caller, args, kwargs, out)
        return out
    return call


def rel_gap(a, b) -> float:
    """max |a - b| / max |b| over the finite entries of both (0 where
    equal to the bit; inf where they differ in finiteness or shape)."""
    if a is None or b is None:
        return 0.0
    if a.shape != b.shape:
        return float("inf")
    if not a.dtype.is_floating_point:
        return 0.0 if torch.equal(a, b) else float("inf")
    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        return float("inf")
    if not fa.any():
        return 0.0
    d = (a[fa] - b[fa]).abs().max()
    return float(d / b[fb].abs().max().clamp(min=1e-300))


def compare(a: OpLog, b: OpLog) -> list:
    """For each call of ``a`` that ``b`` made too, in ``a``'s order: its
    key, its inputs' largest relative gap and its output's."""
    out = []
    for key, (ins_a, out_a) in a.entries.items():
        if key not in b.entries:
            continue
        ins_b, out_b = b.entries[key]
        gin = max((rel_gap(x, y) for x, y in zip(ins_a, ins_b)), default=0.0)
        out.append({"at": key[0], "call": key[1], "n": key[2], "in_gap": gin,
                    "out_gap": rel_gap(out_a, out_b)})
    return out


def summarize(rows: list, top: int = 8) -> dict:
    """The calls whose output parts although their inputs are equal to the
    bit (where a gap is made), and the ``top`` calls that grow a gap the
    most (output gap over input gap), each at its first count."""
    made, seen = [], set()
    for r in rows:
        if r["in_gap"] == 0.0 and r["out_gap"] > 0.0 and (r["at"], r["call"]) not in seen:
            seen.add((r["at"], r["call"]))
            made.append(r)
    grown = sorted((r for r in rows if r["in_gap"] > 0.0 and r["out_gap"] > 0.0),
                   key=lambda r: r["out_gap"] / r["in_gap"], reverse=True)
    return {"calls_compared": len(rows),
            "first_apart": next((r for r in rows if r["out_gap"] > 0.0), None),
            "largest_out_gap": max((r["out_gap"] for r in rows if r["out_gap"] < float("inf")),
                                   default=0.0),
            "gap_made_at": made,
            "gap_grown_most_at": grown[:top]}
