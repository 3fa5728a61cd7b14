"""The flash forward's share of its roofline (``FlashAttentionFn``'s
forward), %."""

from perfbench.metrics._flash import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "FlashAttentionFn", "fwd")
