"""Share of satellite-batch's traced window with no device operation running."""

from mpcbench.readers import idle_pct as read  # noqa: F401
