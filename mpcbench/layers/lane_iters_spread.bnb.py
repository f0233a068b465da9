"""The slowest lane's GI iterations over the batch's mean, averaged over
the batches (satellite-batch): the program's ``bnb.iters`` counter, one
tensor a batch. The slowest lane sets the search launch's time."""

import numpy as np

from mpcbench import spans


def read(ctx):
    vals = [float(np.max(it)) / float(np.mean(it))
            for it in spans.program_counted(ctx, "bnb.iters") if np.mean(it) > 0]
    return float(np.mean(vals)) if vals else None
