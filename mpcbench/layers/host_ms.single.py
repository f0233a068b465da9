"""A single solve's wall ms less its device-busy time, mean over the
traced window (satellite-single)."""

from mpcbench import readers


def read(ctx):
    return readers.host_ms(ctx)
