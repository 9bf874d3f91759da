"""host_syncs_per_query: CUDA calls in the traced window that block the
host until the device catches up (traceread.SYNC_CALLS: stream, device and
event synchronise, blocking copies; a copy down counts by the synchronise
that completes it), per query row answered. None where the trace holds no
CUDA call at all."""

from vdbbench.traceread import SYNC_CALLS


def read(ctx):
    if not ctx.trace.count("cuda_runtime") or not ctx.window.queries:
        return None
    n = ctx.trace.count("cuda_runtime", names=SYNC_CALLS) + ctx.trace.count(
        "cuda_driver", names=SYNC_CALLS)
    return n / ctx.window.queries
