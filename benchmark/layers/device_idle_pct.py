"""device_idle_pct: 100 x (1 - the union of kernel, copy and memset
intervals over the traced window's length). None where the trace holds no
device operation."""


def read(ctx):
    busy = ctx.trace.busy_s()
    return 100.0 * (1.0 - busy / ctx.trace.window_s) if busy else None
