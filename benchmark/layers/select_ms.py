"""select_ms: the time of the program's span `tostore.vector_search.select`
per query in the traced window (vdbbench/spans.py), inside `dispatch`: the
IVF probe's selection over its candidates (the final top-k, a PQ index's
exact re-rank, and `ops.distance.finalize_results`). None where the trace
holds no such span."""

from vdbbench import spans


def read(ctx):
    return spans.per_query(ctx, "vector_search.select")
