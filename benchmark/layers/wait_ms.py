"""wait_ms: the time of the program's span `tostore.vector_search.wait` per
query in the traced window (vdbbench/spans.py): the copies of the distances
and slots down: the host blocked until the device finishes the search. None
where the trace holds no such span."""

from vdbbench import spans


def read(ctx):
    return spans.per_query(ctx, "vector_search.wait")
