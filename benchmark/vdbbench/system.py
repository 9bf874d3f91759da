"""The system under test: the port, `tostore_tpu_torch`, built from a
configuration and loaded with the benchmark's rows.

A traffic mix names its entry: "engine" is a memory database
(`ToStoreTPU.memory`) holding the configuration's table, searched through
`ToStoreTPU.vector_search`. The program is imported inside the class,
never at import time.
Every row's key is its load position and its pk is key + 1.
"""

from __future__ import annotations

import time

import numpy as np


def _program():
    import tostore_tpu_torch

    return tostore_tpu_torch


def launch_counts() -> dict:
    """The program's launch counters and kernel build time, for a run's
    earlier lines; empty where the program has none of these names."""
    out = {}
    try:
        from tostore_tpu_torch.ops import _kernels, ivfprobe, topk
    except ImportError:
        return out
    for table in (getattr(topk, "LAUNCHES", {}), getattr(ivfprobe, "LAUNCHES", {})):
        out.update({k: v for k, v in table.items() if v})
    out["kernel_build_s"] = getattr(_kernels, "build_seconds", None)
    return out


def index_state(idx) -> dict:
    corpus = getattr(idx, "corpus", None)
    return {"capacity": getattr(corpus, "capacity", None), "rows": len(corpus)
            if corpus is not None else None, "trained": getattr(idx, "trained", None)}


def card_state() -> dict:
    """The card's clocks, temperature, power and throttle reasons, as
    nvidia-smi reads them, for a run's earlier lines."""
    import subprocess

    keys = ("clocks.sm", "clocks.mem", "temperature.gpu", "power.draw",
            "clocks_throttle_reasons.active")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(keys)}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=10, check=True)
        return dict(zip(keys, (v.strip() for v in out.stdout.splitlines()[0].split(","))))
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return {"error": repr(exc)}


class EngineTable:
    """A memory database of the port with the configuration's one table."""

    def __init__(self, config: dict, device: str):
        P = _program()
        self.config = config
        self.table, self.field = config["table"], config["vector_field"]
        index = dict(config["index"])
        fields = (
            P.FieldSchema(config["key_field"], P.DataType.bigInt),
            P.FieldSchema(self.field, P.DataType.vector, vector_config=P.VectorFieldConfig(
                dimensions=config["dims"], precision=config["precision"])),
        )
        vconf = P.VectorIndexConfig(metric=config["metric"], **index)
        schema = P.TableSchema(name=self.table, fields=fields, indexes=(
            P.IndexSchema(fields=(self.field,), type="vector", vector_config=vconf),))
        self.db = P.ToStoreTPU.memory(schemas=[schema], device=device)
        self._cond = P.QueryCondition

    def load(self, rows):
        """batch_insert of every chunk of (offset, device rows), in records
        of `load_chunk` rows, each flushed to the index before the next.

        The flush is a one-row search (past the engine's forced-flush row
        count, a search applies every staged write). Without it the
        engine's 2-s background flush moves whatever is staged at its tick,
        so the index's upserts, and with them the corpus's capacity that
        every flat scan reads whole, would change from one process to the
        next (1.125x to 1.625x of 2^20 slots for 20k-row batches)."""
        key, step = self.config["key_field"], self.config["load_chunk"]
        probe = None
        for off, x in rows:
            host = x.cpu().numpy()
            for a in range(0, len(host), step):
                recs = [{"id": off + i + 1, key: off + i, self.field: host[i]}
                        for i in range(a, min(len(host), a + step))]
                res = self.db.batch_insert(self.table, recs)
                if not res.is_success:
                    raise RuntimeError(f"batch_insert at key {off + a}: {res}")
                probe = host[a] if probe is None else probe
                self.db.vector_search(self.table, self.field, probe, top_k=1)

    def index(self):
        return self.db.engine._table(self.table).vector_index_for(self.field)

    def state(self) -> dict:
        """The index's slots on the device (what a flat scan reads), read
        only, for a run's earlier lines."""
        return index_state(self.index())

    def wait_trained(self, limit_s: float) -> float:
        """Runs the engine's vector maintenance job once (the job its
        background tick runs every 30 s, here without the tick's wait for a
        quiet index), then waits, reading only, until the table's index is
        trained; raises past `limit_s`. Returns the seconds.

        Waiting for the tick alone made set-up 30 s longer in about half
        the runs: the load ends on one side of the first tick or the other
        (3-31 s of waiting)."""
        t0 = time.perf_counter()
        self.db.engine.run_vector_maintenance()
        idx = self.index()
        while not idx.trained:
            if time.perf_counter() - t0 > limit_s:
                raise RuntimeError(f"the engine did not train its {idx.index_type} index "
                                   f"within {limit_s} s: it would serve the exact fallback")
            time.sleep(0.05)
            idx = self.index()
        return time.perf_counter() - t0

    def condition(self, filt: dict | None):
        if not filt:
            return None
        return self._cond().where(filt["field"], filt["op"], filt["value"])

    def searcher(self, condition):
        db, table, field, k = self.db, self.table, self.field, self.config["top_k"]

        def search(q):
            return db.vector_search(table, field, q, top_k=k, condition=condition)

        return search

    def answers(self, results: list) -> tuple:
        """[request results] -> pks [Q, k] (-1 past the hits), distances
        [Q, k] (nan past the hits), hit counts [Q]."""
        k = self.config["top_k"]
        pks = np.full((len(results), k), -1, np.int64)
        dists = np.full((len(results), k), np.nan)
        counts = np.zeros(len(results), np.int64)
        for i, hits in enumerate(results):
            hits = hits[:k]
            counts[i] = len(hits)
            pks[i, : len(hits)] = [-1 if h.primary_key is None else h.primary_key for h in hits]
            dists[i, : len(hits)] = [h.distance for h in hits]
        return pks, dists, counts

    def timings(self) -> dict:
        return self.db.timings()

    def close(self):
        self.db.close()
        self.db = None


ENTRIES = {"engine": EngineTable}
