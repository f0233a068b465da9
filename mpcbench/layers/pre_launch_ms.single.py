"""Mean ms from the start of a single solve's ``lmpc.mpc.control`` span to
the start of its ``lmpc.bnb.search`` span (satellite-single): the host
path before the search kernel's launch."""

import numpy as np

from mpcbench import spans


def read(ctx):
    sps = spans.program_spans(ctx)
    start = {s.call: s.start for s in spans.named(sps, "lmpc.mpc.control")}
    vals = [s.start - start[s.call] for s in spans.named(sps, "lmpc.bnb.search")
            if s.call in start]
    return 1e3 * float(np.mean(vals)) if vals else None
