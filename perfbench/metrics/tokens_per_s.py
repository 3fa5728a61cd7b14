"""Real (non-padding) tokens of every step of the window over the window's
seconds; the window closes on a synchronise."""


def read(ctx):
    return ctx.units / ctx.window_s if ctx.unit == "tokens" else None
