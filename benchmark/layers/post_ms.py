"""post_ms: the time of the program's span `tostore.vector_search.post` per
query in the traced window (vdbbench/spans.py): the engine after the index:
the overlay and deferred-flush post-filters, `include_records`, the weight
updates. None where the trace holds no such span."""

from vdbbench import spans


def read(ctx):
    return spans.per_query(ctx, "vector_search.post")
