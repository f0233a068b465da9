"""K1's (``phase1_kernel``, float32) share of its roofline in
invpend-montecarlo: the least time for the warm steps' bulk-phase work,
counted from the reference's working sets (``workmodel_small``), over K1's
device time in the traced window."""

import re

from mpcbench import readers
from mpcbench import workmodel_small as ws

K1 = re.compile(r"(?<![A-Za-z0-9_])phase1_kernel")


def read(ctx):
    m = ctx.shapes["m"]
    return ws.warm_share(lambda w, a: ws.k1_step_flops(m, w, a), ws.k1_lane_bytes(m),
                         ws.k1_launch_bytes(m), ws.PEAK_FLOPS_F32,
                         zip(ctx.stats.get("ws_sizes") or [], ctx.stats.get("added") or []),
                         int(ctx.params["lanes"]), ctx.units * int(ctx.params["steps"]),
                         readers.kernel_seconds(ctx, K1))
