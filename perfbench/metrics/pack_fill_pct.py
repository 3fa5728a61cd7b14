"""Real tokens over slots x slot length, summed over the window's
batches, counted from the delivered segment ids (%)."""


def read(ctx):
    if "positions" not in ctx.work or not ctx.work["positions"]:
        return None
    return 100.0 * ctx.work["tokens"] / ctx.work["positions"]
