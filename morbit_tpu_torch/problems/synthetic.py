"""Benchmark problems and Halton starts.

Counterpart of ``make_two_parabolas`` and ``halton``/``halton_starts`` in
``morbit_tpu/problems/synthetic.py``; the Halton sequence is computed the
same way, so both packages get bit-equal starts.
"""

from __future__ import annotations

import numpy as np
import torch

from morbit_tpu_torch.core.mop import MOP


def _f1(x):
    return torch.sum((x - 1.0) ** 2)


def _f2(x):
    return torch.sum((x + 1.0) ** 2)


def _j1(x):
    return 2.0 * (x - 1.0)


def _j2(x):
    return 2.0 * (x + 1.0)


def make_two_parabolas(model_cfg=None, lb=None, ub=None) -> MOP:
    """``examples/example_two_parabolas.jl``: f1 = |x - 1|^2, f2 = |x + 1|^2;
    exact objectives with analytic Jacobians unless ``model_cfg`` is given.
    The Pareto set is the segment x_1 = ... = x_n in [-1, 1]."""
    mop = MOP(2) if lb is None else MOP(lb, ub)
    if model_cfg is None:
        mop.add_exact_objective(_f1, jac=_j1)
        mop.add_exact_objective(_f2, jac=_j2)
    else:
        mop.add_objective(_f1, model_cfg=model_cfg)
        mop.add_objective(_f2, model_cfg=model_cfg)
    return mop


_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59,
           61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127,
           131, 137, 139, 149, 151, 157, 163, 167, 173]  # covers n <= 40


def halton(count: int, dim: int, start_index: int = 1) -> np.ndarray:
    """Halton low-discrepancy sequence (the reference's benchmark starts,
    ``examples/large_scale_benchmarks.jl``)."""
    if dim > len(_PRIMES):
        raise ValueError(f"halton covers dim <= {len(_PRIMES)}, got {dim}")
    out = np.empty((count, dim))
    for j in range(dim):
        b = _PRIMES[j]
        for i in range(count):
            f, r, idx = 1.0, 0.0, start_index + i
            while idx > 0:
                f /= b
                r += f * (idx % b)
                idx //= b
            out[i, j] = r
    return out


def halton_starts(count: int, lb, ub, start_index: int = 1) -> np.ndarray:
    lb = np.asarray(lb)
    ub = np.asarray(ub)
    u = halton(count, lb.shape[0], start_index)
    return lb + (ub - lb) * u
