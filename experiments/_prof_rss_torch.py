"""Where does the scale soak's peak host RSS happen, on the port (the
counterpart of `_prof_rss.py`)? A scaled soak (2M relational rows + a 50k
x 768 bf16 IVF table on the card) with a background sampler that records
the largest RSS within each phase. The vector corpus lives in device
memory here, so the vector phases show the host copies only (the column
store's f32 rows, staging, snapshot bytes).

    python3 experiments/_prof_rss_torch.py
"""

import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

N_REL, N_VEC, D = 2_000_000, 50_000, 768


def rss_gb():
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS"):
                return int(ln.split()[1]) / 2**20
    return 0.0


class Sampler(threading.Thread):
    """Samples RSS every 50 ms into the peak of the current phase."""

    def __init__(self):
        super().__init__(daemon=True)
        self.phase = "start"
        self.peaks = {}
        self.stopped = threading.Event()

    def run(self):
        while not self.stopped.is_set():
            r, p = rss_gb(), self.phase
            if r > self.peaks.get(p, 0.0):
                self.peaks[p] = r
            time.sleep(0.05)


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
    s = Sampler()
    s.start()
    tmp = tempfile.mkdtemp(prefix="tostore_rss_")
    try:
        db = ToStoreTPU.open(tmp, schemas=[rel, vec], device=dev)
        s.phase = "rel_ingest"
        t0 = time.perf_counter()
        for lo in range(0, N_REL, 500_000):
            db.batch_insert("events", [{"id": i + 1, "a": i % 97, "b": i % 1009}
                                       for i in range(lo, min(lo + 500_000, N_REL))])
        print(f"rel_ingest {time.perf_counter() - t0:.1f}s rss {rss_gb():.2f}", flush=True)
        s.phase = "vec_ingest"
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        for lo in range(0, N_VEC, 25_000):
            X = rng.standard_normal((25_000, D)).astype(np.float32)
            db.batch_insert("docs", [{"id": lo + j + 1, "emb": X[j]} for j in range(25_000)])
        db.vector_search("docs", "emb", np.zeros(D, np.float32), top_k=1)
        print(f"vec_ingest {time.perf_counter() - t0:.1f}s rss {rss_gb():.2f}", flush=True)
        s.phase = "checkpoint"
        t0 = time.perf_counter()
        db.engine.flush(force_all=True)
        print(f"checkpoint {time.perf_counter() - t0:.1f}s rss {rss_gb():.2f}", flush=True)
        s.phase = "tail+kill"
        db.batch_insert("events", [{"id": N_REL + i + 1, "a": 1, "b": 2}
                                   for i in range(100_000)])
        db.engine._crontab and db.engine._crontab.stop()
        del db
        s.phase = "recover_open"
        t0 = time.perf_counter()
        db2 = ToStoreTPU.open(tmp, schemas=[rel, vec], device=dev)
        print(f"recover_open {time.perf_counter() - t0:.1f}s rss {rss_gb():.2f}", flush=True)
        s.phase = "first_touch"
        db2.get_by_pk("events", 5)
        db2.vector_search("docs", "emb", np.zeros(D, np.float32), top_k=1)
        print(f"first_touch rss {rss_gb():.2f}", flush=True)
        s.phase = "end"
        db2.close()
    finally:
        s.stopped.set()
        s.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase peaks (GB):")
    for p, r in s.peaks.items():
        print(f"  {p:14s} {r:.2f}")


if __name__ == "__main__":
    main()
