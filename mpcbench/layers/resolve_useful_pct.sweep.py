"""Share of the lanes re-solved in float64 that float32 had left
uncertified (crazyflie-sweep): the program's counters
``iu.resolve_needed`` over ``iu.resolve_lanes`` in the IU tier's pools."""

from mpcbench import spans


def read(ctx):
    c = spans.program_counts(ctx)
    if not c.get("iu.resolve_lanes"):
        return None
    return 100.0 * c.get("iu.resolve_needed", 0) / c["iu.resolve_lanes"]
