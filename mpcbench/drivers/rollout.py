"""Closed-loop Monte Carlo: one batched rollout after another.

A unit is one call of the program's ``build_rollout`` rollout: ``lanes``
plants from x0 uniform over the configuration's box (fresh from the seed
for each rollout, drawn on the host in float32: the rollout takes host
arrays and carries its state in float32), ``steps`` warm-started control
steps each. Where the program's MPC tracks a reference, each lane also
gets one constant r, uniform over the r part of the box, from a stream
of its own. One lane of each rollout (drawn from the seed) is kept: its
start, reference, states, controls and statuses. The check follows it
step by step from the program's own states and controls. The rate is
lanes x steps of every rollout over the window.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.profiler import record_function

from mpcbench import check
from mpcbench.trace import CALL


class Driver:
    def __init__(self, ctx):
        self.ctx, p = ctx, ctx.params
        self.dev = torch.device(ctx.device)
        self.mpc = ctx.cfg_mod.program(ctx.L, ctx.cfg, ctx.plant).setup(
            device=ctx.device, dtype=torch.float32)
        self.roll = ctx.L.build_rollout(self.mpc)
        self.B, self.N = int(p["lanes"]), int(p["steps"])
        lo, hi = ctx.cfg_mod.theta_box(ctx.cfg)
        nx, nr = self.mpc.get_parameter_dims()[:2]
        self.lo, self.hi = lo[:nx], hi[:nx]
        self.r_lo, self.r_hi = lo[nx:nx + nr], hi[nx:nx + nr]
        self.gen = np.random.default_rng(ctx.stream_seed("x0"))
        self.r_gen = np.random.default_rng(ctx.stream_seed("r"))
        self.warm_gen = np.random.default_rng(ctx.stream_seed("warmup"))
        self.pick = np.random.default_rng(ctx.stream_seed("pick"))
        self.kept, self.kept_r, self.failed = [], [], []
        self.attempted = 0

    def draw(self, gen, lo=None, hi=None):
        lo, hi = (self.lo, self.hi) if lo is None else (lo, hi)
        return gen.uniform(lo, hi, (self.B, len(lo))).astype(np.float32)

    def draw_r(self, gen):
        """One constant reference a lane, or None where the MPC tracks none."""
        return self.draw(gen, self.r_lo, self.r_hi) if len(self.r_lo) else None

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def warmup(self):
        x0 = self.draw(self.warm_gen)
        self.roll(x0, self.draw_r(self.warm_gen), None,
                  N=int(self.ctx.params.get("warmup_steps", 4)))
        self.sync()

    def unit(self):
        x0 = self.draw(self.gen)
        r = self.draw_r(self.r_gen)
        with record_function(CALL):
            res = self.roll(x0, r, None, N=self.N)
        j = int(self.pick.integers(self.B))
        self.kept.append((torch.as_tensor(x0[j]), res.xs[j].clone(), res.us[j].clone(),
                          res.status[j].clone()))
        self.kept_r.append(np.zeros(0) if r is None else r[j].astype(np.float64))
        self.failed.append((res.status != 1).sum())
        self.sync()
        self.attempted += self.B * self.N

    def answers(self) -> dict:
        x0, xs, us, st = (torch.stack(list(x)).cpu().numpy() for x in zip(*self.kept))
        return {"x0": x0.astype(np.float64), "r": np.array(self.kept_r),
                "xs": xs.astype(np.float64), "us": us.astype(np.float64), "status": st,
                "failed": int(sum(int(f) for f in self.failed))}

    def end_to_end(self, elapsed: float) -> dict:
        return {"control_steps_per_s": self.attempted / elapsed}

    def release(self):
        self.mpc = self.roll = None
        self.kept, self.kept_r, self.failed = [], [], []


def chosen(ctx, answers) -> np.ndarray:
    n = len(answers["xs"])
    k = min(int(ctx.spec["check"]["lanes"]), n)
    return np.sort(np.random.default_rng(ctx.stream_seed("check")).choice(n, k, replace=False))


def judge(ctx, answers):
    u_err = x_err = 0.0
    sizes, added = [], []
    for i in chosen(ctx, answers):
        xs = answers["xs"][i]
        u, x, s, a = check.judge_rollout(ctx.qp, ctx.plant, answers["x0"][i], xs,
                                         answers["us"][i], answers["status"][i], range(len(xs)),
                                         answers["r"][i])
        u_err, x_err = max(u_err, u), max(x_err, x)
        sizes += s
        added += a
    return {"u_err": u_err, "x_err": x_err}, {"ws_sizes": sizes, "added": added}


def control(ctx, answers):
    """The closed loop in bfloat16, below the program's float32 state, in
    the program's place on the checked lanes."""
    out = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in answers.items()}
    for i in chosen(ctx, answers):
        xs, us, st = check.control_rollout(ctx.qp, ctx.plant, answers["x0"][i],
                                           len(answers["xs"][i]), "bfloat16", answers["r"][i])
        out["xs"][i], out["us"][i], out["status"][i] = xs, us, st
    return out
