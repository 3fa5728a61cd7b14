"""The 95th percentile of every step interval of the window: between
consecutive step-start events on the compute stream (the last to the
window's closing event), so time the card waits for a batch counts."""

import numpy as np


def read(ctx):
    if len(ctx.step_intervals_ms) < 20:
        return None
    return float(np.percentile(ctx.step_intervals_ms, 95))
