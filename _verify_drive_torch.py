"""End-to-end drive of the PyTorch port's engine on the card (the steps of
`_verify_drive.py`, the JAX package's): ingest 30k x 256 bf16 vectors into
a flat table of a file database, search, checkpoint, write a WAL tail,
crash (the WAL and the background jobs severed, no close), reopen (WAL
replay) and search again with the same pks, then reopen once more without
a checkpoint in between and recount.

    python3 _verify_drive_torch.py

`drive(device=, rows=, tail=)` runs the same steps elsewhere (the tests:
the CPU, a small size). Prints "VERIFY DRIVE OK" last; any failure
raises and exits non-zero.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np

D = 256


def _schema():
    from tostore_tpu_torch import (
        DataType,
        FieldSchema,
        IndexSchema,
        TableSchema,
        VectorFieldConfig,
        VectorIndexConfig,
    )

    return TableSchema(
        name="docs",
        fields=(
            FieldSchema("tag", DataType.integer),
            FieldSchema("emb", DataType.vector,
                        vector_config=VectorFieldConfig(dimensions=D, precision="bfloat16")),
        ),
        indexes=(
            IndexSchema(fields=("emb",), type="vector",
                        vector_config=VectorIndexConfig(index_type="flat", metric="l2")),
        ),
    )


def _crash(db):
    """A hard drop: sever the WAL and the background jobs, no checkpoint."""
    db.engine._wal.close()
    db.engine._crontab.stop()


def drive(device: str = "cuda", rows: int = 30_000, tail: int = 2_000):
    from bench_torch import require_device
    from tostore_tpu_torch import ToStoreTPU

    dev = str(require_device(device))
    schema = _schema()
    tmp = tempfile.mkdtemp(prefix="tostore_vdrive_")
    rng = np.random.default_rng(7)
    try:
        db = ToStoreTPU.open(tmp, schemas=[schema], device=dev)
        X = rng.standard_normal((rows, D)).astype(np.float32)
        t0 = time.perf_counter()
        db.batch_insert("docs", [{"id": i + 1, "tag": i % 5, "emb": X[i]} for i in range(rows)])
        print(f"ingest {rows} x {D}: {time.perf_counter() - t0:.2f}s", flush=True)

        q = X[1234]
        t0 = time.perf_counter()
        r1 = db.vector_search("docs", "emb", q, top_k=5)
        print(f"search1 {time.perf_counter() - t0:.2f}s "
              f"top={[(h.primary_key, round(h.score, 4)) for h in r1[:3]]}", flush=True)
        if r1[0].primary_key != 1235:
            raise AssertionError(f"search1: {r1[0]}")

        t0 = time.perf_counter()
        db.flush()  # checkpoint
        print(f"checkpoint: {time.perf_counter() - t0:.2f}s", flush=True)

        # tail writes after the checkpoint live only in the WAL
        Y = rng.standard_normal((tail, D)).astype(np.float32)
        db.batch_insert("docs", [{"id": 40_000 + i, "tag": 9, "emb": Y[i]} for i in range(tail)])
        qt = Y[77]
        rt = db.vector_search("docs", "emb", qt, top_k=3)
        if rt[0].primary_key != 40_077:
            raise AssertionError(f"tail search: {rt[0]}")
        _crash(db)
        del db

        t0 = time.perf_counter()
        db2 = ToStoreTPU.open(tmp, schemas=[schema], device=dev)
        open_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r2 = db2.vector_search("docs", "emb", q, top_k=5)
        touch_s = time.perf_counter() - t0
        print(f"reopen {open_s:.2f}s, first touch {touch_s:.2f}s", flush=True)
        if [h.primary_key for h in r2] != [h.primary_key for h in r1]:
            raise AssertionError(f"after reopen: {r1} != {r2}")
        rt2 = db2.vector_search("docs", "emb", qt, top_k=3)
        if rt2[0].primary_key != 40_077:
            raise AssertionError(f"tail after reopen: {rt2[0]}")
        if db2.count("docs") != rows + tail:
            raise AssertionError(f"count after reopen {db2.count('docs')} != {rows + tail}")
        print("recovered_wal_entries:",
              db2.engine.status()["counters"].get("recovered_wal_entries"), flush=True)
        # the replayed tail must replay idempotently: reopen once more with
        # no checkpoint in between (the deferred fold), and recount
        _crash(db2)
        del db2
        db3 = ToStoreTPU.open(tmp, schemas=[schema], device=dev)
        try:
            if db3.count("docs") != rows + tail:
                raise AssertionError(f"count after the second reopen {db3.count('docs')}")
            r3 = db3.vector_search("docs", "emb", q, top_k=5)
            if [h.primary_key for h in r3] != [h.primary_key for h in r1]:
                raise AssertionError(f"after the second reopen: {r1} != {r3}")
        finally:
            db3.close()
        print("VERIFY DRIVE OK", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    drive()
