"""engine_ms: the engine's own time per search in the traced window, from
its timer (`ToStoreTPU.timings()["vector_search"]`: total ms over count),
which wraps the whole of `Database.vector_search`. None without the engine."""


def read(ctx):
    t = ctx.timings.get("vector_search")
    return t["total_ms"] / t["count"] if t else None
