"""Lanes the float64 finish of the small-m warm step took, a control step
(invpend-montecarlo): the program's counter ``small.roll_fixed`` over the
steps of the traced rollouts; the lanes K1 and K2 left unresolved, which
the step would otherwise report at -1."""

from mpcbench import spans


def read(ctx):
    c = spans.program_counts(ctx)
    if "small.roll_fixed" not in c:
        return None
    return c["small.roll_fixed"] / (ctx.units * int(ctx.params["steps"]))
