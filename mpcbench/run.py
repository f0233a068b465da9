#!/usr/bin/env python3
"""Run one cell of the benchmark of ``linearmpc_tpu_torch`` once, on the
CUDA cards of this machine, and print the result as the last line of
standard output (one JSON object).

    python3 mpcbench/run.py --workload crazyflie-sweep --seed 7 --seconds 20 --trace 0

``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` runs the cell's ``trace_units`` units under
``torch.profiler`` and reports its per-layer metrics. Both check the
outputs against the plain reference and print each compared number with
its limit as the last lines of standard error. Without the cards the cell
asks for, it exits with 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _finite(x):
    """JSON has no infinity: an infinitely wrong number prints as the
    largest float."""
    if isinstance(x, float) and not math.isfinite(x):
        return sys.float_info.max if x > 0 else -sys.float_info.max
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="put the reference, one precision below the configuration's, in the "
                         "program's place for the output check (sets the limits; not a benchmark run)")
    args = ap.parse_args(argv)

    # one process with one host thread: a steadier load on a shared host
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)
    from mpcbench import harness

    spec = harness.load_json(os.path.join(HERE, "workloads", f"{args.workload}.json"))
    import torch

    torch.set_num_threads(1)
    chips = int(spec.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mpcbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              control=args.control)
    bad = harness.forbidden_modules()
    if bad:
        print(f"mpcbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in result["checked"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
