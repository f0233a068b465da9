"""Device kernels launched a control step of the rollout
(crazyflie-closedloop)."""

from mpcbench import readers


def read(ctx):
    n = readers.launches(ctx)
    return n / (ctx.units * int(ctx.params["steps"])) if n else None
