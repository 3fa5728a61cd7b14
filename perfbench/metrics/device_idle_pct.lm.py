"""Share of the traced window in which no kernel, copy or memset ran on
the card (%)."""

from perfbench.metrics._shared import device_idle_pct as read  # noqa: F401
