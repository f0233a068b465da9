"""Cold batches of theta, one after another: a closed loop of one caller.

A unit is one ``SolverEngine.solve_batch`` of ``params.batch`` lanes, theta
uniform over the configuration's box, fresh for every batch from the
seed (drawn on the device). One lane of each batch (its index drawn from
the seed) is kept for the output check. The rate is the lanes of every
batch over the window, the window closing when the last batch started in
it returns.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.profiler import record_function

from mpcbench import reference as ref
from mpcbench.check import Judge
from mpcbench.trace import CALL


class Driver:
    def __init__(self, ctx):
        self.ctx, p = ctx, ctx.params
        self.dev = torch.device(ctx.device)
        self.mpc = ctx.cfg_mod.program(ctx.L, ctx.cfg, ctx.plant).setup(
            device=ctx.device, dtype=torch.float32)
        self.engine = self.mpc.engine
        self.B = int(p["batch"])
        lo, hi = ctx.cfg_mod.theta_box(ctx.cfg)
        self.lo = torch.as_tensor(lo, dtype=torch.float64, device=self.dev)
        self.span = torch.as_tensor(hi - lo, dtype=torch.float64, device=self.dev)
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(ctx.stream_seed("theta"))
        self.warm_gen = torch.Generator(device=self.dev)
        self.warm_gen.manual_seed(ctx.stream_seed("warmup"))
        self.pick = np.random.default_rng(ctx.stream_seed("pick"))
        self.kept, self.statuses = [], []
        self.attempted = 0

    def draw(self, gen):
        u = torch.rand((self.B, len(self.lo)), generator=gen, dtype=torch.float64, device=self.dev)
        return self.lo + self.span * u

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def warmup(self):
        for _ in range(int(self.ctx.params.get("warmup_units", 2))):
            self.engine.solve_batch(self.draw(self.warm_gen))
        self.sync()

    def unit(self):
        th = self.draw(self.gen)
        with record_function(CALL):
            sol = self.engine.solve_batch(th)
        j = int(self.pick.integers(self.B))
        self.kept.append((th[j].clone(), sol.U[j].clone(), sol.status[j].clone()))
        self.statuses.append(sol.status.clone())
        self.sync()
        self.attempted += self.B

    def answers(self) -> dict:
        th, U, st = (torch.stack(list(x)).cpu().numpy() for x in zip(*self.kept))
        return {"theta": th, "U": U.astype(np.float64), "status": st,
                "failed": int((torch.stack(self.statuses) != 1).sum())}

    def end_to_end(self, elapsed: float) -> dict:
        return {self.ctx.params["rate_metric"]: self.attempted / elapsed}

    def release(self):
        self.mpc = self.engine = None
        self.kept, self.statuses = [], []


def chosen(ctx, answers) -> np.ndarray:
    """The kept lanes that the check compares, drawn from the seed."""
    n = len(answers["U"])
    k = min(int(ctx.spec["check"]["lanes"]), n)
    return np.sort(np.random.default_rng(ctx.stream_seed("check")).choice(n, k, replace=False))


def judge(ctx, answers):
    judge = Judge(ctx.qp)
    errs = [judge.lane(answers["theta"][i], answers["U"][i], int(answers["status"][i]))
            for i in chosen(ctx, answers)]
    stats = {"ws_sizes": judge.ws_sizes, "nodes": judge.nodes, "work": judge.work,
             "ties": judge.ties, "checked": len(errs)}
    return {"u_err": max(errs)}, stats


def control(ctx, answers):
    """The reference in float32 in the program's place on the checked lanes."""
    solver = ref.Solver(ctx.qp, np.float32)
    out = dict(answers, U=answers["U"].copy(), status=answers["status"].copy())
    for i in chosen(ctx, answers):
        th = answers["theta"][i]
        if len(ctx.qp.bin_rows):
            v = ref.branch_and_bound(solver, th).v
        else:
            v = solver.solve(th)[0]
        out["U"][i], out["status"][i] = v, 1
    return out
