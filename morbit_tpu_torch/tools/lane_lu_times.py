"""K6's float64 factor at one size over growing batch widths, on the card.

Past k = 169 K6 factors each lane in place in global memory, one block a
lane, unblocked: every column streams the lane's whole trailing matrix. So
its time grows with the width once the lanes' matrices no longer share the
card's 50 MB L2. For each width B this times one launch of the factor's C
call (CUDA events) on random (B, k, k) float64 matrices, and the library's
``torch.linalg.lu_factor_ex`` on the same; it stops before a width whose
time, carried over linearly from the last, would pass ``--budget-s``. One
JSON line, with the card's name.

    python3 -m morbit_tpu_torch.tools.lane_lu_times [--k 1377] [--widths 4 8 16 32 64] [--budget-s 60]
"""

from __future__ import annotations

import argparse
import json

import torch


def _ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--k", type=int, default=1377)
    p.add_argument("--widths", type=int, nargs="*", default=[4, 8, 16, 32, 64])
    p.add_argument("--budget-s", type=float, default=60.0)
    args = p.parse_args(argv)
    from morbit_tpu_torch.ops import lane_linalg as ll

    g = torch.Generator(device="cuda").manual_seed(0)
    rows, last = [], None
    for B in args.widths:
        if last is not None and last[1] * B / last[0] > 1e3 * args.budget_s:
            rows.append({"B": B, "skipped": "projected past the budget",
                         "projected_ms": last[1] * B / last[0]})
            break
        A = torch.randn(B, args.k, args.k, dtype=torch.float64, device="cuda", generator=g)
        LU, perm, info = (torch.empty_like(A), torch.empty(B, args.k, dtype=torch.int32,
                                                           device="cuda"),
                          torch.empty(B, dtype=torch.int32, device="cuda"))
        launch = ll.factor_launcher(A, LU, perm, info)
        launch()                                    # builds and loads the kernel
        ms = _ms(launch)
        lib_ms = _ms(lambda: torch.linalg.lu_factor_ex(A))
        rows.append({"B": B, "ms": ms, "ms_per_lane": ms / B, "library_ms": lib_ms,
                     "place": ll.lu_factor_plan(args.k, 8).instance})
        last = (B, ms)
        del A, LU, perm, info
    print(json.dumps({"tool": "lane_lu_times", "card": torch.cuda.get_device_name(0),
                      "k": args.k, "dtype": "float64", "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
