"""Device kernels launched a ``solve_batch`` (crazyflie-sweep)."""

from mpcbench import readers


def read(ctx):
    n = readers.launches(ctx)
    return n / ctx.units if n else None
