"""The search kernel's device ms a single solve, mean over the traced
window (satellite-single)."""

from mpcbench import readers


def read(ctx):
    s = readers.kernel_seconds(ctx, readers.SEARCH)
    return 1e3 * s / ctx.units if s > 0 else None
