"""Device-idle ms a batch inside the program's ``lmpc.engine.solve_batch``
span (crazyflie-sweep): the host's share of ``solve_batch`` in which no
device operation runs."""

from mpcbench import spans


def read(ctx):
    sp = spans.named(spans.program_spans(ctx), "lmpc.engine.solve_batch")
    idle = spans.idle_inside(ctx, sp)
    return None if idle is None else 1e3 * idle / len(sp)
