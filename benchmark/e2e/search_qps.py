"""search_qps: searches completed over the whole window."""


def read(ctx):
    w = ctx.window
    return w.requests / w.elapsed_s if w.requests else None
