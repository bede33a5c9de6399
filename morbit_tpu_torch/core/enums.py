"""Iteration/stop/radius enums.

Same integer codes as the JAX package's ``morbit_tpu/core/enums.py`` (they
are stored in the solver state's int32 tensors and compared across the two
packages by the tests). Semantics follow the reference enums at
``src/globals.jl:119-146``.
"""

from enum import IntEnum


class ITER_TYPE(IntEnum):
    """Classification of one trust-region iteration (``src/globals.jl:119-130``)."""

    ACCEPTABLE = 0      # accept trial point, shrink radius
    SUCCESSFULL = 1     # accept trial point, grow radius   (sic — reference spelling)
    MODELIMPROVING = 2  # reject trial point, keep radius
    INACCEPTABLE = 3    # reject trial point, shrink radius (much)
    RESTORATION = 4     # a restoration step was used as the next iterate
    FILTER_FAIL = 5     # trial point not acceptable for the filter
    FILTER_ADD = 6      # acceptable to filter, large constraint violation
    EARLY_EXIT = 7
    INITIALIZATION = 8


class STOP_CODE(IntEnum):
    """Return codes of :func:`morbit_tpu_torch.optimize` (``src/globals.jl:132-139``)."""

    CONTINUE = 1
    MAX_ITER = 2
    BUDGET_EXHAUSTED = 3
    CRITICAL = 4
    TOLERANCE = 5
    INFEASIBLE = 6


class RADIUS_UPDATE(IntEnum):
    """Radius update decision (``src/globals.jl:141-146``)."""

    LEAVE_UNCHANGED = 0
    GROW = 1
    SHRINK = 2
    SHRINK_MUCH = 3
