"""kernels_per_query: kernels the device ran in the traced window, per
query row answered."""


def read(ctx):
    n = ctx.trace.count("kernel")
    return n / ctx.window.queries if n and ctx.window.queries else None
