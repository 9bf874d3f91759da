"""dispatch_ms: the time of the program's span `tostore.vector_search.dispatch`
per query in the traced window (vdbbench/spans.py): the host's time to
enqueue the scan and the selection: the per-slot bias,
`ops.topk.flat_search` (or the IVF probe) and
`ops.distance.finalize_results`. None where the trace holds no such span."""

from vdbbench import spans


def read(ctx):
    return spans.per_query(ctx, "vector_search.dispatch")
