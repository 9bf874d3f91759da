"""prep_ms: the time of the program's span `tostore.vector_search.prep` per
query in the traced window (vdbbench/spans.py): the index's query
preparation on the host: norms, padding and the copies up. None where the
trace holds no such span."""

from vdbbench import spans


def read(ctx):
    return spans.per_query(ctx, "vector_search.prep")
