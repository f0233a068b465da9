"""Ms from the search kernel's end to ``solve_batch``'s return, mean a
batch (satellite-batch): ``IncFrontier.finish``'s float64 polish and
status work."""

from mpcbench import readers


def read(ctx):
    return readers.after_kernel_ms(ctx, readers.SEARCH)
