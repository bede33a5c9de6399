"""Entry point of the port: one batched trust-region iteration.

The counterpart of ``__graft_entry__.entry``: the solver's "forward step"
is one full trust-region iteration (surrogate update, criticality LP,
backtracking, trial evaluation, acceptance) over a batch of independent
instances, here eight starts of the main path (two parabolas, one
multiquadric RBF group, ``max_iter=10, qp_iters=100``) at float32.
``dryrun_multichip`` shards over devices and waits for the multi-device
runner.

    python3 -m morbit_tpu_torch.entry [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def entry(device=None):
    """(fn, args): ``fn(*args)`` runs one ``Solver.iterate`` on B=8 lanes of
    the main path, on CUDA unless ``device`` says otherwise."""
    from morbit_tpu_torch import AlgorithmConfig
    from morbit_tpu_torch.models.configs import RbfConfig
    from morbit_tpu_torch.parallel.multistart import build_solver
    from morbit_tpu_torch.problems.synthetic import make_two_parabolas

    mop = make_two_parabolas(RbfConfig(kernel="multiquadric"), [-4.0, -4.0], [4.0, 4.0])
    solver = build_solver(mop, AlgorithmConfig(max_iter=10, qp_iters=100),
                          torch.float32, device)
    x0 = np.random.default_rng(0).uniform(-3, 3, (8, 2))
    return solver.iterate, (solver.initialize(x0),)


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
