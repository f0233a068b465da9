"""Device-idle ms a control step inside the program's ``lmpc.small.*`` spans
(invpend-montecarlo): the host's share of the small-m tier's warm step (the
bounds, K1's launch, K2's launch and the status) in which no device
operation runs."""

from mpcbench import spans


def read(ctx):
    sp = [s for s in spans.program_spans(ctx) if s.name.startswith("lmpc.small.")]
    idle = spans.idle_inside(ctx, sp)
    return None if idle is None else 1e3 * idle / (ctx.units * int(ctx.params["steps"]))
