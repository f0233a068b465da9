"""Mean ms of a ``lmpc.rollout.step`` span outside its ``lmpc.rollout.solve``
child: the rollout loop's own host time a step (measurement, observer,
theta, plant step, appends), crazyflie-closedloop."""

import numpy as np

from mpcbench import spans


def read(ctx):
    sps = spans.program_spans(ctx)
    kids = spans.children(sps)
    vals = [spans.self_seconds(s, kids.get(s.index, []), only=("lmpc.rollout.solve",))
            for s in spans.named(sps, "lmpc.rollout.step")]
    return 1e3 * float(np.mean(vals)) if vals else None
