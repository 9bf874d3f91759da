"""mask_ms: the time of the program's span `tostore.vector_search.mask` per
query in the traced window (vdbbench/spans.py): the hybrid filter's slot
mask inside the capture (`filters.device_mask`, or the host fallback); only
searches with a condition have it. None where the trace holds no such span."""

from vdbbench import spans


def read(ctx):
    return spans.per_query(ctx, "vector_search.mask")
