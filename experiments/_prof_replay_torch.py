"""Reopen-after-kill breakdown on the port (the counterpart of
`_prof_replay.py`): where does the time of `wal_replay_rows_per_s` (config
#12) go: snapshot load, the replay of the WAL tail, or the checkpoint
after it? 4M relational rows are checkpointed, 500k more live only in the
WAL, the handle is dropped without close(), and the reopen is timed by
phase and under cProfile. Host work (no vector table); the database is
opened on the card as the soak's is.

    python3 experiments/_prof_replay_torch.py
"""

import cProfile
import pstats
import shutil
import sys
import tempfile
import time
from pathlib import Path

N_REL = 4_000_000
TAIL_ROWS = 500_000


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bench_torch import require_device
    import tostore_tpu_torch.engine.database as dbmod
    from tostore_tpu_torch import DataType, FieldSchema, TableSchema, ToStoreTPU

    dev = str(require_device("cuda"))
    rel = TableSchema(name="events", fields=(FieldSchema("a", DataType.integer),
                                             FieldSchema("b", DataType.integer)))
    tmp = tempfile.mkdtemp(prefix="tostore_replay_")
    try:
        db = ToStoreTPU.open(tmp, schemas=[rel], device=dev)
        t0 = time.perf_counter()
        for lo in range(0, N_REL, 500_000):
            db.batch_insert("events", [{"id": i + 1, "a": i % 97, "b": i % 1009}
                                       for i in range(lo, min(lo + 500_000, N_REL))])
        print(f"ingest: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        db.engine.flush(force_all=True)
        print(f"checkpoint: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        db.batch_insert("events", [{"id": N_REL + i + 1, "a": 1, "b": 2}
                                   for i in range(TAIL_ROWS)])
        print(f"tail ingest: {time.perf_counter() - t0:.1f}s", flush=True)
        db.engine._crontab and db.engine._crontab.stop()
        del db

        # time the reopen's phases
        orig_replay = dbmod.Database._replay_stream
        orig_flush = dbmod.Database.flush

        def timed_replay(self, entries):
            t = time.perf_counter()
            n = orig_replay(self, entries)
            print(f"  _replay_stream: {time.perf_counter() - t:.2f}s ({n} entries)", flush=True)
            return n

        def timed_flush(self, *a, **k):
            t = time.perf_counter()
            r = orig_flush(self, *a, **k)
            print(f"  flush: {time.perf_counter() - t:.2f}s", flush=True)
            return r

        dbmod.Database._replay_stream = timed_replay
        dbmod.Database.flush = timed_flush
        try:
            t0 = time.perf_counter()
            prof = cProfile.Profile()
            prof.enable()
            db2 = ToStoreTPU.open(tmp, schemas=[rel], device=dev)
            prof.disable()
            reopen_s = time.perf_counter() - t0
        finally:
            dbmod.Database._replay_stream = orig_replay
            dbmod.Database.flush = orig_flush
        print(f"reopen: {reopen_s:.2f}s -> {TAIL_ROWS / reopen_s:,.0f} rows/s", flush=True)
        pstats.Stats(prof).sort_stats("cumulative").print_stats(25)
        db2.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
