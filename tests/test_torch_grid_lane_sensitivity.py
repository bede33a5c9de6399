"""How far lane 1 of the grid setting ``zdt1-n5-rbf_cubic-steepest_descent-s4``
carries a rounding, on the CPU at float64 (ROADMAP 3.20).

``chip_smoke.py``'s ``grid_card_vs_cpu`` holds this lane's card run within
``GRID_MAY_PART``'s bound of the CPU run. Here the CPU run is held against
itself: the lane's Halton start moved by one ulp in one coordinate, the
run ends with the same integers but its fx moves by more than that bound.
So any float64 rounding the card computes differently (a solve, a product,
a sum, a transcendental) may move the lane's end past it.
"""

import numpy as np
import pytest
import torch

from chip_smoke import GRID_MAY_PART
from morbit_tpu_torch import multistart_optimize
from morbit_tpu_torch.parallel.benchmarks import Setting, _default_config, make_problem
from morbit_tpu_torch.problems.synthetic import halton_starts

SETTING = Setting("zdt1", 5, "rbf_cubic", "steepest_descent", 4)
LANE = 1


def _run(starts):
    mop = make_problem(SETTING.problem, SETTING.n_vars, SETTING.model)
    r = multistart_optimize(mop, torch.as_tensor(starts), _default_config(SETTING),
                            torch.float64, device="cpu")
    return r.fx[LANE].numpy(), (int(r.n_iterations[LANE]), int(r.stop_code[LANE]),
                                int(r.n_evals[LANE].sum()))


@pytest.mark.parametrize("coordinate", [0, 2])
def test_one_ulp_moves_the_lane_past_its_grid_bound(coordinate):
    mop = make_problem(SETTING.problem, SETTING.n_vars, SETTING.model)
    starts = halton_starts(SETTING.n_starts, mop.lb, mop.ub)
    fx, ints = _run(starts)
    moved = starts.copy()
    moved[LANE, coordinate] = np.nextafter(moved[LANE, coordinate], np.inf)
    fx_moved, ints_moved = _run(moved)
    bound, _ = GRID_MAY_PART[SETTING.key][LANE]
    assert ints_moved == ints
    assert np.abs(fx_moved - fx).max() > bound
