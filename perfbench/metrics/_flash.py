"""The flash attention call's share of its roofline: the least time its
work could take on the card (visible-pair FLOPs at the TF32 peak, or each
input read once and each output written once at the HBM rate, whichever
is longer) over the device time the profiler gives the kernels launched
inside the port's attention op."""

from perfbench.work import least_seconds


def roofline_pct(ctx, op, direction):
    if ctx.trace is None:
        return None
    seconds = ctx.trace.op_device_s.get(op)
    flops = ctx.work.get(f"flash_{direction}_flops")
    if not seconds or not flops:
        return None
    return 100.0 * least_seconds(flops, ctx.work[f"flash_{direction}_bytes"]) / seconds
