"""The flash backward's share of its roofline (``FlashAttentionFn``'s
backward: dQ, then dK/dV), %."""

from perfbench.metrics._flash import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "FlashAttentionFnBackward", "bwd")
