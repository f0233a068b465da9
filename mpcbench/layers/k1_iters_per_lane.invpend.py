"""K1's iterations a lane and step (invpend-montecarlo): the program's
counters ``small.k1_iters`` over ``small.lanes``; what the warm start from
the previous step's working set buys."""

from mpcbench import spans


def read(ctx):
    c = spans.program_counts(ctx)
    return c.get("small.k1_iters", 0) / c["small.lanes"] if c.get("small.lanes") else None
