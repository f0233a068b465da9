"""Device-idle ms a batch inside the program's ``lmpc.bnb.finish`` span
(satellite-batch): the float64 polish and the statuses after the search,
while no device operation runs."""

from mpcbench import spans


def read(ctx):
    sp = spans.named(spans.program_spans(ctx), "lmpc.bnb.finish")
    idle = spans.idle_inside(ctx, sp)
    return None if idle is None else 1e3 * idle / len(sp)
