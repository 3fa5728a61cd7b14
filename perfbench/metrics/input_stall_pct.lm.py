"""Share of the traced window in which the card idled waiting for the
loader: device idle gaps that begin inside the benchmark's span around
``next()`` on the loader (%)."""

from perfbench.metrics._shared import input_stall_pct as read  # noqa: F401
