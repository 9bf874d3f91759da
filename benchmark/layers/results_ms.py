"""results_ms: the time of the program's span `tostore.vector_search.results`
per query in the traced window (vdbbench/spans.py): pks from slots
(`DeviceCorpus.pks_for_slots`), scores and the result objects. None where
the trace holds no such span."""

from vdbbench import spans


def read(ctx):
    return spans.per_query(ctx, "vector_search.results")
