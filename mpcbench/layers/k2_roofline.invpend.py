"""K2's (``polish_kernel``, float64) share of its roofline in
invpend-montecarlo: the least time for the warm steps' polish work,
counted from the reference's working sets (``workmodel_small``), over K2's
device time in the traced window."""

import re

from mpcbench import readers
from mpcbench import workmodel_small as ws

K2 = re.compile(r"(?<![A-Za-z0-9_])polish_kernel")


def read(ctx):
    m, n, nth = ctx.shapes["m"], ctx.shapes["n"], ctx.shapes["n_theta"]
    return ws.warm_share(lambda w, a: ws.k2_step_flops(m, n, nth, w), ws.k2_lane_bytes(m, n, nth),
                         ws.k2_launch_bytes(m, n, nth), ws.PEAK_FLOPS_F64,
                         zip(ctx.stats.get("ws_sizes") or [], ctx.stats.get("added") or []),
                         int(ctx.params["lanes"]), ctx.units * int(ctx.params["steps"]),
                         readers.kernel_seconds(ctx, K2))
