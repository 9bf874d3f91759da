"""aten_ops_per_query: aten operators the host dispatched in the traced
window (every `aten::` CPU event, nested ones included), per query row
answered."""


def read(ctx):
    n = ctx.trace.count("cpu_op", prefix="aten::")
    return n / ctx.window.queries if n and ctx.window.queries else None
