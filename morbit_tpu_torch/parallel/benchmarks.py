"""Feature-grid benchmark harness with resume and saving.

Counterpart of ``morbit_tpu/parallel/benchmarks.py``, the reference's
``examples/large_scale_benchmarks.jl``: a settings table over (problem x
n_vars x model x descent x Halton starts), each setting one batched
multistart, with incremental saving and resume from a partial file
(``fill_from_partial_results!``, ``large_scale_benchmarks.jl:131-134``).
Observations recorded per run: ``n_evals``, the final iterate ``x``, the
final criticality ``omega``, iterations and the stop code
(``large_scale_benchmarks.jl:124,239-241``).

Names, defaults, keys and the save file's layout are the JAX package's, so
a file that either package wrote resumes in the other, setting by setting.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from morbit_tpu_torch.core.algorithm import resolve_device
from morbit_tpu_torch.core.config import AlgorithmConfig
from morbit_tpu_torch.core.descent import PascolettiSerafiniConfig
from morbit_tpu_torch.core.mop import compile_mop
from morbit_tpu_torch.models.configs import LagrangeConfig, RbfConfig, TaylorConfig
from morbit_tpu_torch.parallel.multistart import (StagedMultistart, mesh_devices,
                                                  multistart_optimize)
from morbit_tpu_torch.problems.synthetic import (halton_starts, make_dtlz,
                                                 make_two_parabolas, make_zdt)

#: the model grid of the reference benchmarks (``large_scale_benchmarks.jl:69-118``)
MODEL_CFGS = {
    "rbf_cubic": lambda: RbfConfig(kernel="cubic"),
    "rbf_multiquadric": lambda: RbfConfig(kernel="multiquadric"),
    "taylor1": lambda: TaylorConfig(degree=1, mode="fd"),
    "taylor2": lambda: TaylorConfig(degree=2, mode="fd"),
    "lagrange1": lambda: LagrangeConfig(degree=1),
    "lagrange2": lambda: LagrangeConfig(degree=2),
    "exact": lambda: None,
}

DESCENTS = {
    "steepest_descent": "steepest_descent",
    # the reference's default PS budgets (``_ps_max_evals``,
    # ``descent.jl:414-432``)
    "ps": lambda: PascolettiSerafiniConfig(),
    # a cheaper PS variant
    "ps_small": lambda: PascolettiSerafiniConfig(n_samples=128, polish_iters=25),
}


def make_problem(name: str, n_vars: int, model: str):
    cfg = MODEL_CFGS[model]()
    if name.startswith("zdt"):
        return make_zdt(name, n_vars, model_cfg=cfg)
    if name.startswith("dtlz"):
        return make_dtlz(int(name[4:]), n_vars, M=2, model_cfg=cfg)
    if name == "two_parabolas":
        assert n_vars == 2
        return make_two_parabolas(model_cfg=cfg, lb=[-4.0, -4.0], ub=[4.0, 4.0])
    raise ValueError(f"unknown problem {name!r}")


@dataclasses.dataclass(frozen=True)
class Setting:
    """One row group of the settings table (one solver, many starts)."""

    problem: str
    n_vars: int
    model: str
    descent: str
    n_starts: int

    @property
    def key(self) -> str:
        return f"{self.problem}-n{self.n_vars}-{self.model}-{self.descent}-s{self.n_starts}"


def generate_all_settings(
    problems: Sequence[str] = ("zdt1", "zdt2", "zdt3"),
    n_vars_list: Sequence[int] = (2, 5, 10),
    models: Sequence[str] = ("rbf_cubic", "taylor1", "lagrange1", "lagrange2"),
    descents: Sequence[str] = ("steepest_descent",),
    n_starts: int = 8,
):
    """The Cartesian settings grid (``generate_all_settings``)."""
    return [Setting(p, n, m, d, n_starts)
            for p in problems for n in n_vars_list for m in models for d in descents]


def _default_config(setting: Setting, **overrides) -> AlgorithmConfig:
    """The reference benchmark's defaults (``large_scale_benchmarks.jl:181,203-210``):
    max_evals = 1000*n_vars, max_iter = 100, delta_0 = 0.1, delta_max = 0.5,
    tolerances 1e-3."""
    descent = DESCENTS[setting.descent]
    kw = dict(
        max_evals=1000 * setting.n_vars,
        max_iter=100,
        delta_0=0.1,
        delta_max=0.5,
        f_tol_rel=1e-3,
        x_tol_rel=1e-3,
        descent_method=descent() if callable(descent) else descent,
    )
    kw.update(overrides)
    return AlgorithmConfig(**kw)


def _sync(devices):
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def perform_test(setting: Setting, dtype=torch.float32, device=None, mesh=None,
                 steady_state: bool = False, staged: bool = False, **cfg_overrides):
    """Run one settings group: a batched multistart over Halton starts, on
    CUDA unless ``device`` says otherwise.

    Returns a dict of observations (NumPy arrays, one row per start, taken
    off the device after the clock stops) and ``wall_s``, the first call's
    seconds. With ``steady_state=True`` a second call on a distinct start
    batch of the same shape is timed too (``steady_state_s``,
    ``steady_runs_per_sec``), and ``compile_s_approx`` is ``wall_s`` less
    ``steady_state_s``. In the JAX package that difference is the jit
    compile; here nothing is compiled per setting (each CUDA kernel is
    built once a process, at its first launch), so it measures the first
    call's warm-up and the two batches' different work, and may be
    negative. ``staged=True`` runs :class:`StagedMultistart` (equal to the
    plain runner lane by lane), otherwise :func:`multistart_optimize`.
    ``mesh`` shards the starts over its devices (``parallel/multistart.py``;
    the result lies on its first device, the clock stops after every
    device's sync)."""
    device = resolve_device(device) if mesh is None else mesh_devices(mesh)[0]
    mop = make_problem(setting.problem, setting.n_vars, setting.model)
    ac = _default_config(setting, **cfg_overrides)
    n_s = setting.n_starts
    x0_all = halton_starts(n_s * (2 if steady_state else 1), mop.lb, mop.ub)
    x0_all = torch.as_tensor(x0_all, dtype=dtype, device=device)
    if staged:
        run = StagedMultistart(mop, ac, dtype, device=device, mesh=mesh)
    else:
        cmop = compile_mop(mop, ac.combine_models)
        run = lambda xb: multistart_optimize(cmop, xb, ac, dtype, device, mesh)
    devices = (device,) if mesh is None else tuple(dict.fromkeys(mesh_devices(mesh)))

    _sync(devices)
    t0 = time.perf_counter()
    res = run(x0_all[:n_s])
    _sync(devices)
    wall = time.perf_counter() - t0

    steady = None
    if steady_state:
        t0 = time.perf_counter()
        run(x0_all[n_s:])
        _sync(devices)
        steady = time.perf_counter() - t0

    traj = res.state.traj
    last = (traj.count.long() - 1).clamp(0, traj.data.shape[1] - 1)
    omega_final = traj.omega[torch.arange(last.shape[0], device=last.device), last]
    host = lambda t: t.cpu().numpy()
    out = {
        "x": host(res.x),
        "fx": host(res.fx),
        "n_evals": host(res.n_evals),
        "n_iterations": host(res.n_iterations),
        "stop_code": host(res.stop_code),
        "omega": host(omega_final),
        "wall_s": wall,
    }
    if steady is not None:
        out["steady_state_s"] = steady
        out["steady_runs_per_sec"] = round(n_s / steady, 3)
        out["compile_s_approx"] = round(wall - steady, 3)
    return out


def run_benchmarks(settings, save_path: Optional[str] = None, resume: bool = True,
                   dtype=torch.float32, device=None, mesh=None, verbose: bool = True,
                   steady_state: bool = False, staged: bool = False, **cfg_overrides):
    """Run every settings group with incremental JSON saving and resume: a
    setting whose key the save file holds is not run again. A setting that
    raises is recorded as ``{"error": repr(e)}`` and the next one runs,
    like the reference's ``try/catch``. ``mesh`` as for
    :func:`perform_test`."""
    results = {}
    if save_path and resume and os.path.exists(save_path):
        with open(save_path) as f:
            results = json.load(f)
        if verbose:
            print(f"resumed {len(results)} finished settings from {save_path}")

    for s in settings:
        if s.key in results:
            continue
        try:
            obs = perform_test(s, dtype=dtype, device=device, mesh=mesh,
                               steady_state=steady_state, staged=staged, **cfg_overrides)
            results[s.key] = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                              for k, v in obs.items()}
            if verbose:
                print(f"{s.key}: evals={obs['n_evals'].tolist()} "
                      f"wall={obs['wall_s']:.2f}s")
        except Exception as e:  # keep going like the reference's try/catch
            results[s.key] = {"error": repr(e)}
            if verbose:
                print(f"{s.key}: ERROR {e!r}")
        if save_path:
            with open(save_path, "w") as f:
                json.dump(results, f)
    return results
