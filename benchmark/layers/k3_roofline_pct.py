"""k3_roofline_pct: the least time of the bytes the window's queries make
K3 read (vdbbench.k3roofline, from the configuration alone: nprobe x N / C
rows with their f32 bias and the bf16 query, at 3.35 TB/s) over the
device time of K3's kernels (`ivf_bucket_probe` and its pre-pass
`ivf_group_pairs`) in the traced window, in percent. None without such
kernels or a count."""

from vdbbench import k3roofline


def read(ctx):
    least = k3roofline.least_ms_per_query(ctx.config)
    kernel_s = k3roofline.kernel_s(ctx.trace)
    if least is None or not kernel_s or not ctx.window.queries:
        return None
    return 100.0 * least * 1e-3 * ctx.window.queries / kernel_s
