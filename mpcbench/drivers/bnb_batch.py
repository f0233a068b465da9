"""Cold batches of hybrid MPC problems through branch-and-bound: the batch
driver of ``sweep.py``, whose check (``check.Judge``) holds the binary
rows to the reference's own branch-and-bound."""

from mpcbench.drivers.sweep import Driver, chosen, control, judge  # noqa: F401
