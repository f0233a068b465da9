"""The embedded controller: one single solve after another.

A unit is one ``MPC.compute_control_trajectory`` call at B = 1, the solve
behind ``compute_control`` returning the whole plan U (its first control
is U[:nu] - K x), with theta = [x; r] uniform over the configuration's
box, drawn from the seed on the host (the entry takes NumPy). Its latency
runs from the call to the plan it returns. Every call's theta and plan are
kept; the check compares a sample drawn from the seed. The plan, not
u_0 alone, lets the check tell another binary assignment that a float32
search cannot order from a wrong answer. A call whose solver status is
below 1 fails.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.autograd.profiler import record_function

from mpcbench import reference as ref
from mpcbench.check import Judge
from mpcbench.trace import CALL


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mpc = ctx.cfg_mod.program(ctx.L, ctx.cfg, ctx.plant).setup(
            device=ctx.device, dtype=torch.float32)
        self.lo, hi = ctx.cfg_mod.theta_box(ctx.cfg)
        self.span = hi - self.lo
        self.nx = self.mpc.model.nx
        self.rng = np.random.default_rng(ctx.stream_seed("theta"))
        self.warm_rng = np.random.default_rng(ctx.stream_seed("warmup"))
        self.theta, self.U, self.ok, self.latency = [], [], [], []
        self.attempted = 0

    def call(self, th):
        x, r = th[:self.nx], th[self.nx:]
        try:
            return self.mpc.compute_control_trajectory(x, r=r if len(r) else None), True
        except AssertionError:
            return np.full(self.ctx.qp.H.shape[0], np.nan), False

    def warmup(self):
        for _ in range(int(self.ctx.params.get("warmup_units", 3))):
            self.call(self.lo + self.span * self.warm_rng.uniform(size=len(self.lo)))

    def unit(self):
        th = self.lo + self.span * self.rng.uniform(size=len(self.lo))
        t0 = time.perf_counter()
        with record_function(CALL):
            U, ok = self.call(th)
        self.latency.append(time.perf_counter() - t0)
        self.theta.append(th)
        self.U.append(U)
        self.ok.append(ok)
        self.attempted += 1

    def answers(self) -> dict:
        return {"theta": np.array(self.theta), "U": np.array(self.U), "ok": np.array(self.ok),
                "failed": int(len(self.ok) - sum(self.ok))}

    def end_to_end(self, elapsed: float) -> dict:
        return {"solve_p95_ms": 1e3 * float(np.percentile(self.latency, 95))}

    def release(self):
        self.mpc = None


def chosen(ctx, answers) -> np.ndarray:
    n = len(answers["U"])
    k = min(int(ctx.spec["check"]["lanes"]), n)
    return np.sort(np.random.default_rng(ctx.stream_seed("check")).choice(n, k, replace=False))


def judge(ctx, answers):
    judge = Judge(ctx.qp)
    errs = [judge.lane(answers["theta"][i], answers["U"][i], 1 if answers["ok"][i] else -1)
            for i in chosen(ctx, answers)]
    return {"u_err": max(errs)}, {"nodes": judge.nodes, "work": judge.work, "ties": judge.ties}


def control(ctx, answers):
    """The reference's branch-and-bound in float32 in the program's place
    on the checked solves."""
    solver = ref.Solver(ctx.qp, np.float32)
    out = dict(answers, U=answers["U"].copy(), ok=answers["ok"].copy())
    for i in chosen(ctx, answers):
        th = answers["theta"][i]
        v = ref.branch_and_bound(solver, th).v if len(ctx.qp.bin_rows) else solver.solve(th)[0]
        out["U"][i], out["ok"][i] = v, True
    return out
