"""Batched multistart optimization.

Counterpart of ``build_solver`` and ``multistart_optimize`` in
``morbit_tpu/parallel/multistart.py``: one optimize() per row of a (B, n)
batch of starts, run as B lanes of one batched solve (the reference's
``Threads.@threads`` benchmark loop, ``examples/large_scale_benchmarks.jl``).
The staged and compacted runners arrive in a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from morbit_tpu_torch.core.algorithm import (OptimizeResult, Solver,
                                             resolve_device)
from morbit_tpu_torch.core.config import AlgorithmConfig
from morbit_tpu_torch.core.mop import CompiledMOP, compile_mop


def build_solver(mop, algo_config: Optional[AlgorithmConfig] = None,
                 dtype=torch.float32, device=None) -> Solver:
    ac = algo_config or AlgorithmConfig()
    cmop = mop if isinstance(mop, CompiledMOP) else compile_mop(mop, ac.combine_models)
    return Solver(cmop, ac, dtype, resolve_device(device))


def multistart_optimize(mop, x0_batch,
                        algo_config: Optional[AlgorithmConfig] = None,
                        dtype=torch.float32, device=None) -> OptimizeResult:
    """Run one full optimize() per row of ``x0_batch`` (B, n), batched on
    one device (CUDA unless ``device`` says otherwise). Every field of the
    result carries the lane axis first."""
    return build_solver(mop, algo_config, dtype, device).solve(x0_batch)
