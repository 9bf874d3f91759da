"""k1_roofline_pct: the least time of the work the window's queries need of
a flat scan (vdbbench.k1roofline, from the configuration and the batch
alone: the rows read once in the field's type, plus queries and hits, at
3.35 TB/s) over the device time of K1's kernel (`lane_topk_kernel` on f32
rows, `lane_scan_kernel` on bf16 and int8, the instances with T > 0) in the
traced window, in percent. None without such a kernel or a count."""

from vdbbench import k1roofline


def read(ctx):
    least = k1roofline.least_ms_per_query(ctx.config, int(ctx.traffic["batch"]))
    kernel_s = k1roofline.kernel_s(ctx.trace)
    if least is None or not kernel_s or not ctx.window.queries:
        return None
    return 100.0 * least * 1e-3 * ctx.window.queries / kernel_s
