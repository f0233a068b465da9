"""K3's (``iu_kernel``) share of its roofline in crazyflie-closedloop: the
least time for the warm steps' work over K3's device time."""

from mpcbench import readers


def read(ctx):
    return readers.warm_roofline(ctx, readers.K3)
