"""Device-busy time (the union of kernels, copies and memsets) of the
traced window over its steps (ms)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.steps:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.steps
