"""Entry point of the port: one batched trust-region iteration.

The counterpart of ``__graft_entry__.entry``: the solver's "forward step"
is one full trust-region iteration (surrogate update, criticality LP,
backtracking, trial evaluation, acceptance) over a batch of independent
instances, here eight starts of the main path (two parabolas, one
multiquadric RBF group, ``max_iter=10, qp_iters=100``) at float32.

:func:`dryrun_multichip` (``n_devices``, ``device=None``) is the
counterpart of ``__graft_entry__.dryrun_multichip``: one
``initialize`` + ``iterate`` step with the batch sharded over a mesh of
``n_devices`` CUDA devices, then a full float64 solve sharded against
unsharded. A machine with fewer cards raises, unless ``device`` names one
device to repeat ``n_devices`` times (the CPU in the tests).

    python3 -m morbit_tpu_torch.entry [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _main_path(dtype, device):
    """(problem, config, solver) of the main path at ``max_iter=10,
    qp_iters=100``."""
    from morbit_tpu_torch import AlgorithmConfig
    from morbit_tpu_torch.models.configs import RbfConfig
    from morbit_tpu_torch.parallel.multistart import build_solver
    from morbit_tpu_torch.problems.synthetic import make_two_parabolas

    mop = make_two_parabolas(RbfConfig(kernel="multiquadric"), [-4.0, -4.0], [4.0, 4.0])
    ac = AlgorithmConfig(max_iter=10, qp_iters=100)
    return mop, ac, build_solver(mop, ac, dtype, device)


def entry(device=None):
    """(fn, args): ``fn(*args)`` runs one ``Solver.iterate`` on B=8 lanes of
    the main path, on CUDA unless ``device`` says otherwise."""
    solver = _main_path(torch.float32, device)[2]
    x0 = np.random.default_rng(0).uniform(-3, 3, (8, 2))
    return solver.iterate, (solver.initialize(x0),)


def dryrun_multichip(n_devices: int, device=None) -> str:
    """The main path's step (``initialize`` + one ``iterate``) at float32
    with a batch of ``2 n_devices`` starts sharded over a mesh of
    ``n_devices`` devices, each shard on its device; then the full float64
    solve sharded against unsharded: integer leaves equal, float leaves
    within 1e-12. The mesh is the first ``n_devices`` CUDA devices, and a
    machine with fewer raises; ``device`` instead repeats one device
    ``n_devices`` times. Returns the line it prints."""
    from morbit_tpu_torch.parallel.multistart import (mesh_devices, multistart_optimize,
                                                      run_sharded, shard_bounds)
    from morbit_tpu_torch.utils.carry import state_to_numpy

    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA "
                               f"devices and this machine has {have}; pass device= to "
                               "repeat one device")
        mesh = mesh_devices([f"cuda:{i}" for i in range(n_devices)])
    else:
        mesh = mesh_devices([device] * n_devices)
    batch = 2 * n_devices
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-3, 3, (batch, 2)))

    solvers = {d: _main_path(torch.float32, d)[2] for d in dict.fromkeys(mesh)}

    parts = run_sharded(mesh, [
        lambda d=d, lo=lo, hi=hi: solvers[d].iterate(solvers[d].initialize(x0[lo:hi])).x
        for d, (lo, hi) in zip(mesh, shard_bounds(batch, len(mesh)))])
    x = torch.cat([p.to(mesh[0]) for p in parts])
    if not (x.shape == (batch, 2) and bool(torch.isfinite(x).all())):
        raise RuntimeError(f"dryrun_multichip: the sharded step gave x of shape "
                           f"{tuple(x.shape)} with non-finite entries")

    mop, ac, _ = _main_path(torch.float64, mesh[0])
    sharded = multistart_optimize(mop, x0, ac, torch.float64, mesh=mesh)
    single = multistart_optimize(mop, x0, ac, torch.float64, device=mesh[0])
    a, b = state_to_numpy(sharded.state), state_to_numpy(single.state)
    bad = [k for k in b if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
           or (not np.array_equal(a[k], b[k]) if b[k].dtype.kind in "biu"
               else not np.allclose(a[k], b[k], rtol=1e-12, atol=1e-12, equal_nan=True))]
    if bad:
        raise RuntimeError(f"dryrun_multichip: {len(bad)} leaves differ between the "
                           f"sharded and the unsharded solve: {bad}")
    line = (f"dryrun_multichip({n_devices}): ok - step sharded over {len(mesh)} "
            f"devices ({', '.join(str(d) for d in mesh)}), batch {batch}; full f64 solve "
            f"sharded == unsharded (ints exact, floats <= 1e-12; {len(b)} leaves)")
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    args = argparse.ArgumentParser()
    args.add_argument("--device", default=None)
    fn, fargs = entry(args.parse_args(argv).device)
    out = fn(*fargs)
    if out.x.is_cuda:
        torch.cuda.synchronize(out.x.device)
    print("entry(): ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
