"""Time the PyTorch port's float32 hybrid batch on the CPU.

The satellite example at Np = Nc (default 20, m = 60, the incremental
frontier's rounds on the plain step), B lanes of theta in +-1 from seed 1,
one torch thread, through ``setup(device="cpu", dtype=float32)`` and
``engine.solve_batch``. Prints the host-clock seconds of each call, the
lanes at status 1 and the sum of fval (equal on two commits that agree).

  python tools/time_cpu_hybrid.py [--root DIR] [--B 16] [--Np 20] [--reps 3]

``--root`` imports ``linearmpc_tpu_torch`` from another checkout (to time
two commits with one script, in one process each).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--B", type=int, default=16)
    ap.add_argument("--Np", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args()
    sys.path.insert(0, a.root)
    import numpy as np
    import torch

    import linearmpc_tpu_torch as tmpc

    torch.set_num_threads(1)
    mpc, _ = tmpc.mpc_examples("satellite", a.Np, a.Np)
    eng = mpc.setup(device="cpu", dtype=torch.float32).engine
    th = np.random.default_rng(1).uniform(-1.0, 1.0, (a.B, eng.ldp.n_theta))
    times = []
    for _ in range(a.reps):
        t0 = time.perf_counter()
        sol = eng.solve_batch(th)
        times.append(time.perf_counter() - t0)
    st = sol.status.numpy()
    print(f"root {a.root}: satellite Np={a.Np} m={eng.ldp.m} B={a.B}, "
          f"bnb_mode {eng.bnb_mode}: seconds {', '.join(f'{t:.3f}' for t in times)} "
          f"(best {min(times):.3f}); status 1 on {int(np.sum(st == 1))} of {a.B} lanes, "
          f"fval sum {float(sol.fval.double().sum()):.12e}")


if __name__ == "__main__":
    main()
