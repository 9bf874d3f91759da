"""capture_ms: the time of the program's span `tostore.vector_search.capture`
per query in the traced window (vdbbench/spans.py): the engine's capture
under its lock (lock acquisition included): the index resolved, pending
writes flushed or deferred, the hybrid slot mask, the overlay, the index
pinned in shared mode. None where the trace holds no such span."""

from vdbbench import spans


def read(ctx):
    return spans.per_query(ctx, "vector_search.capture")
