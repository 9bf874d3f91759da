"""probes_ms: the time of the program's span `tostore.vector_search.probes`
per query in the traced window (vdbbench/spans.py), inside `dispatch`: the
IVF probe's choice of its nprobe slices (the centroid scores, spread over
the slices, and their top nprobe). None where the trace holds no such
span."""

from vdbbench import spans


def read(ctx):
    return spans.per_query(ctx, "vector_search.probes")
