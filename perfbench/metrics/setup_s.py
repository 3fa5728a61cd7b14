"""Process start to the first timed step: imports, the store, the weights,
the kernels from the build cache, the checked and warm-up steps."""


def read(ctx):
    return ctx.setup_s
