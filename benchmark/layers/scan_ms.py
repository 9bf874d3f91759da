"""scan_ms: the time of the program's span `tostore.vector_search.scan` per
query in the traced window (vdbbench/spans.py), inside `dispatch`: the IVF
probe's scan of the probed slices (the bucket bias and K3 with its
grouping pre-pass for raw rows; the ADC tables and K4 for PQ). None where
the trace holds no such span."""

from vdbbench import spans


def read(ctx):
    return spans.per_query(ctx, "vector_search.scan")
