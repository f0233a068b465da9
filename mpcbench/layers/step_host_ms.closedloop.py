"""Mean ms of the program's ``lmpc.rollout.step`` span, one control step of
the rollout on the host's clock (crazyflie-closedloop)."""

import numpy as np

from mpcbench import spans


def read(ctx):
    sp = spans.named(spans.program_spans(ctx), "lmpc.rollout.step")
    return 1e3 * float(np.mean([s.end - s.start for s in sp])) if sp else None
