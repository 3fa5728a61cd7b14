"""Model FLOPs of the window's real tokens (6 x the matmul parameters a
token, the tied head included, plus attention over each document's
causal pairs, forward and backward) over the window's seconds, as a share
of the card's published TF32 peak (%)."""

from perfbench.work import PEAKS


def read(ctx):
    flops = ctx.work.get("model_flops")
    if not flops or ctx.trace is None:
        return None
    return 100.0 * flops / ctx.window_s / PEAKS["tf32_flops"]
