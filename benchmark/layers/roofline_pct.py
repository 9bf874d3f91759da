"""roofline_pct: the least time of the work the window's queries need
(vdbbench.roofline, from the configuration and the batch alone: for flat
the corpus read once a call, for IVF nprobe x N / C rows and the C
centroids a query, plus queries and hits) over the device's kernel time in
the traced window, in percent. None without kernel time or a work count."""

from vdbbench.roofline import least_ms_per_query


def read(ctx):
    kernel_s = ctx.trace.kernel_s()
    least = least_ms_per_query(ctx.config, int(ctx.traffic["batch"]))
    if not kernel_s or least is None or not ctx.window.queries:
        return None
    return 100.0 * least * 1e-3 * ctx.window.queries / kernel_s
