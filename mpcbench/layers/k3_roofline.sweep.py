"""K3's (``iu_kernel``) share of its roofline in crazyflie-sweep: the least
time for the cold lanes' work over K3's device time."""

from mpcbench import readers


def read(ctx):
    return readers.cold_roofline(ctx, readers.K3)
