"""Arithmetic the per-layer metric readers share."""


def input_stall_pct(ctx):
    """Device idle time whose gaps begin inside the benchmark's
    ``perfbench.next_batch`` span (the card waiting for the loader), over
    the traced window. A host wait in ``next()`` while the card still
    runs the last step's work is not a stall and does not count."""
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * ctx.trace.idle_under.get("perfbench.next_batch", 0.0) / ctx.trace.window_s


def device_idle_pct(ctx):
    """Share of the traced window with no kernel, copy or memset running."""
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
