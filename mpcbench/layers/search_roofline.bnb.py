"""K3 search entry's (``search_kernel``) share of its roofline in
satellite-batch: the least time for the reference's branch-and-bound work
over the search kernel's device time."""

from mpcbench import readers


def read(ctx):
    return readers.search_roofline(ctx, readers.SEARCH)
