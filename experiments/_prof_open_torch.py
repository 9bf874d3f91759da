"""Clean-open profile on the port (the counterpart of `_prof_open.py`):
2M relational rows and a 50k x 768 bf16 IVF table on the card, checkpointed
and closed, then the reopen under cProfile, with peak host RSS beside
each step and the first touch of the relational table.

    python3 experiments/_prof_open_torch.py
"""

import cProfile
import os
import pstats
import resource
import shutil
import sys
import tempfile
import time
from pathlib import Path

N_REL, N_VEC, D = 2_000_000, 50_000, 768


def rss():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**10


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import numpy as np

    from bench_torch import require_device
    from tostore_tpu_torch import (
        DataType,
        FieldSchema,
        IndexSchema,
        TableSchema,
        ToStoreTPU,
        VectorFieldConfig,
        VectorIndexConfig,
    )

    dev = str(require_device("cuda"))
    rel = TableSchema(name="events", fields=(FieldSchema("a", DataType.integer),
                                             FieldSchema("b", DataType.integer)))
    vec = TableSchema(
        name="docs",
        fields=(FieldSchema("emb", DataType.vector, vector_config=VectorFieldConfig(
            dimensions=D, precision="bfloat16")),),
        indexes=(IndexSchema(fields=("emb",), type="vector",
                             vector_config=VectorIndexConfig(index_type="ivf", metric="l2")),),
    )
    tmp = tempfile.mkdtemp(prefix="prof_open_")
    try:
        db = ToStoreTPU.open(tmp, schemas=[rel, vec], device=dev)
        t0 = time.perf_counter()
        for lo in range(0, N_REL, 500_000):
            db.batch_insert("events", [{"id": i + 1, "a": i % 97, "b": i % 1009}
                                       for i in range(lo, min(lo + 500_000, N_REL))])
        print(f"rel ingest {time.perf_counter() - t0:.1f}s rss={rss():.0f}MB", flush=True)
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        for lo in range(0, N_VEC, 25_000):
            X = rng.standard_normal((25_000, D)).astype(np.float32)
            db.batch_insert("docs", [{"id": lo + j + 1, "emb": X[j]} for j in range(25_000)])
        db.vector_search("docs", "emb", np.zeros(D, np.float32), top_k=1)
        print(f"vec ingest {time.perf_counter() - t0:.1f}s rss={rss():.0f}MB", flush=True)
        t0 = time.perf_counter()
        db.engine.flush(force_all=True)
        print(f"checkpoint {time.perf_counter() - t0:.1f}s", flush=True)
        db.close()
        du = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(tmp) for f in fs)
        print(f"on disk {du / 2**30:.2f} GB; rss after ingest/close {rss():.0f}MB", flush=True)

        t0 = time.perf_counter()
        pr = cProfile.Profile()
        pr.enable()
        db2 = ToStoreTPU.open(tmp, schemas=[rel, vec], device=dev)
        pr.disable()
        print(f"clean open {time.perf_counter() - t0:.2f}s rss={rss():.0f}MB", flush=True)
        pstats.Stats(pr).sort_stats("cumulative").print_stats(25)
        t0 = time.perf_counter()
        n = db2.query("events").count()
        print(f"count={n} in {time.perf_counter() - t0:.2f}s", flush=True)
        db2.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
