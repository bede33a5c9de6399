"""morbit_tpu_torch — the multiobjective trust-region solver in PyTorch + CUDA.

A port of the JAX package ``morbit_tpu`` (which stays the reference) to
PyTorch on NVIDIA GPUs. The state of every run carries a leading lane axis,
so a batch of starts is one batched solve (:func:`multistart_optimize`) and
a single :func:`optimize` run is the batch of one. Hand-written CUDA
kernels, each built with ``nvcc`` at first use, carry the solver: the ADMM
that solves the trust-region LPs (``csrc/qp_admm.cu``), the RBF
training-site selection, rounds 1-3 (``csrc/rbf_selection.cu``) and round 4
(``csrc/rbf_round4.cu``), and the RBF Gram matrix of wide problems
(``csrc/rbf_gram.cu``); ``csrc/admm_iterations.cu`` ports the one Pallas
kernel that no path calls.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a CUDA device the default raises. Ported so far: exact, RBF, Taylor and
Lagrange models, composite functions, steepest and Pascoletti-Serafini
descent, linear and nonlinear constraints, the trust-region loop with
criticality micro-steps, the ``'auto'`` and ``'model'`` scaling modes,
``use_db=False``, database recycling (``populated_db``) and the final
report (``utils/logging.py``), state checkpoints (``utils/checkpoint.py``),
the plain batched multistart runner, the staged runner
(:class:`StagedMultistart`: capacity stages, the fleet loop, lane
compaction and its probe tuning) with its bench
(``python3 -m morbit_tpu_torch.bench``), the compacted runner
(:class:`CompactedMultistart`: stages and a bucket ladder), the ZDT/DTLZ
benchmark problems and the reference's benchmark grid
(``parallel/benchmarks.py``: :func:`generate_all_settings`,
:func:`perform_test`, :func:`run_benchmarks` with save and resume), the
parametric runner (:func:`parametric_multistart`: one problem instance a
lane), the ``mesh`` form of the runners (the lanes sharded over devices,
:func:`default_mesh`) and the live in-loop log (``optimize(verbosity=3..5)``).
"""

from morbit_tpu_torch.core.algorithm import (OptimizeResult, Solver, SolverState,
                                             initialize_state, optimize)
from morbit_tpu_torch.core.config import AlgorithmConfig
from morbit_tpu_torch.core.enums import ITER_TYPE, RADIUS_UPDATE, STOP_CODE
from morbit_tpu_torch.core.mop import MOP, CompiledMOP, compile_mop
from morbit_tpu_torch.core.descent import PascolettiSerafiniConfig, SteepestDescentConfig
from morbit_tpu_torch.models.configs import (ExactConfig, LagrangeConfig, RbfConfig,
                                             TaylorConfig)
from morbit_tpu_torch.parallel.benchmarks import (Setting, generate_all_settings,
                                                  perform_test, run_benchmarks)
from morbit_tpu_torch.parallel.multistart import (CompactedMultistart, StagedMultistart,
                                                  compacted_multistart, default_mesh,
                                                  multistart_optimize,
                                                  parametric_multistart,
                                                  staged_multistart)

__version__ = "0.1.0"

__all__ = [
    "MOP",
    "compile_mop",
    "CompiledMOP",
    "AlgorithmConfig",
    "ExactConfig",
    "RbfConfig",
    "TaylorConfig",
    "LagrangeConfig",
    "SteepestDescentConfig",
    "PascolettiSerafiniConfig",
    "optimize",
    "initialize_state",
    "Solver",
    "SolverState",
    "multistart_optimize",
    "StagedMultistart",
    "staged_multistart",
    "CompactedMultistart",
    "compacted_multistart",
    "parametric_multistart",
    "default_mesh",
    "Setting",
    "generate_all_settings",
    "perform_test",
    "run_benchmarks",
    "OptimizeResult",
    "ITER_TYPE",
    "STOP_CODE",
    "RADIUS_UPDATE",
]
