"""Branch-and-bound nodes a lane (satellite-batch): the program's counters
``bnb.nodes`` over ``bnb.lanes``."""

from mpcbench import spans


def read(ctx):
    c = spans.program_counts(ctx)
    return c.get("bnb.nodes", 0) / c["bnb.lanes"] if c.get("bnb.lanes") else None
