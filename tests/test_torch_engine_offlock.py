"""The engine-level cases of the JAX package's off-lock search tests
(tests/test_offlock_search.py: TestOffLockSearch, TestBoundedStalenessFlush,
TestBackgroundVectorFlush) and of its background retrain / compaction
tests (tests/test_vector_indexes.py: test_engine_background_retrain,
test_engine_background_compaction,
test_filter_update_invalidates_inflight_build), run on the port:
`tostore_tpu_torch.ToStoreTPU` with `device="cpu"`, where the wrappers run
the kernels' plain versions. The engine releases its lock across a search
with the index pinned in shared mode (utils/rwlock.py); IVF indexes train
and compact off-lock in `run_vector_maintenance`. Also here: what the port
itself adds to the engine (the device carried from the config down to the
indexes, a mesh_shape down to the sharded indexes, device memory info,
the profiler hook, launch counters under threads).
"""

import threading
import time

import numpy as np
import pytest
import torch

from tostore_tpu_torch import QueryCondition, ToStoreTPU
from tostore_tpu_torch.models.schema import (
    DataType,
    FieldSchema,
    IndexSchema,
    TableSchema,
    VectorFieldConfig,
    VectorIndexConfig,
)
from tostore_tpu_torch.utils.rwlock import rw

torch.set_num_threads(1)


def _vec_schema(name="docs"):
    return TableSchema(
        name=name,
        fields=(
            FieldSchema("n", DataType.integer),
            FieldSchema(
                "emb", DataType.vector,
                vector_config=VectorFieldConfig(dimensions=8),
            ),
        ),
        indexes=(
            IndexSchema(fields=("emb",), type="vector",
                        vector_config=VectorIndexConfig(index_type="flat")),
        ),
    )


def _plain_schema(name="plain"):
    return TableSchema(
        name=name,
        fields=(FieldSchema("v", DataType.integer),),
    )


@pytest.fixture
def db(tmp_path):
    store = ToStoreTPU.memory(schemas=[_vec_schema(), _plain_schema()], device="cpu")
    rng = np.random.default_rng(0)
    store.batch_insert(
        "docs",
        [
            {"id": i, "n": i, "emb": rng.standard_normal(8).tolist()}
            for i in range(64)
        ],
    )
    # force a flush so the committed index is populated
    store.vector_search("docs", "emb", np.zeros(8, np.float32), top_k=1)
    yield store
    store.close()


class TestOffLockSearch:
    def test_searches_overlap(self, db):
        """Two engine-level searches must be inside the device dispatch at
        the same time — impossible under the old whole-op engine lock."""
        eng = db.engine
        t = eng._table("docs")
        idx = t.vector_indexes["emb"]
        barrier = threading.Barrier(2, timeout=5)
        real = type(idx).search
        overlapped = []

        def slow_search(self, *a, **kw):
            barrier.wait()  # only passes if BOTH threads are inside
            overlapped.append(True)
            return real(self, *a, **kw)

        type(idx).search = slow_search
        try:
            q = np.zeros(8, np.float32)
            th = [
                threading.Thread(
                    target=lambda: db.vector_search("docs", "emb", q, top_k=3)
                )
                for _ in range(2)
            ]
            for x in th:
                x.start()
            for x in th:
                x.join(10)
        finally:
            type(idx).search = real
        assert len(overlapped) == 2

    def test_crud_proceeds_during_search(self, db):
        """An insert to another table completes while a search is parked
        inside the device dispatch."""
        eng = db.engine
        idx = eng._table("docs").vector_indexes["emb"]
        in_search = threading.Event()
        release = threading.Event()
        real = type(idx).search

        def parked(self, *a, **kw):
            in_search.set()
            release.wait(5)
            return real(self, *a, **kw)

        type(idx).search = parked
        try:
            th = threading.Thread(
                target=lambda: db.vector_search(
                    "docs", "emb", np.zeros(8, np.float32), top_k=3
                )
            )
            th.start()
            assert in_search.wait(5)
            t0 = time.perf_counter()
            db.insert("plain", {"id": 1, "v": 1})
            db.insert("docs", {"id": 1000, "n": 1000, "emb": [0.0] * 8})
            assert db.get_by_pk("plain", 1)["v"] == 1
            assert time.perf_counter() - t0 < 2.0  # did not wait for search
        finally:
            release.set()
            type(idx).search = real
            th.join(10)

    def test_flush_waits_for_inflight_search(self, db):
        """A vector flush on the SAME field blocks until the in-flight
        search releases shared mode (no torn corpus mid-scan)."""
        eng = db.engine
        t = eng._table("docs")
        idx = t.vector_indexes["emb"]
        in_search = threading.Event()
        release = threading.Event()
        real = type(idx).search

        def parked(self, *a, **kw):
            in_search.set()
            release.wait(5)
            return real(self, *a, **kw)

        type(idx).search = parked
        try:
            th = threading.Thread(
                target=lambda: db.vector_search(
                    "docs", "emb", np.zeros(8, np.float32), top_k=3
                )
            )
            th.start()
            assert in_search.wait(5)
            db.insert("docs", {"id": 2000, "n": 2000, "emb": [1.0] * 8})
            flushed = []

            def flush():
                with eng._lock:
                    t.flush_vectors("emb")
                flushed.append(True)

            tf = threading.Thread(target=flush)
            tf.start()
            time.sleep(0.1)
            assert not flushed  # blocked behind the shared holder
            release.set()
            tf.join(5)
            assert flushed
        finally:
            release.set()
            type(idx).search = real
            th.join(10)

    def test_concurrent_search_insert_soak(self, db):
        """8 searcher threads + a writer thread, results always valid."""
        stop = threading.Event()
        errors = []

        def searcher(seed):
            rng = np.random.default_rng(seed)
            try:
                while not stop.is_set():
                    q = rng.standard_normal(8).astype(np.float32)
                    hits = db.vector_search("docs", "emb", q, top_k=5)
                    for h in hits:
                        assert h.primary_key is not None
                        assert np.isfinite(h.distance)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        def writer():
            rng = np.random.default_rng(99)
            i = 10_000
            try:
                while not stop.is_set():
                    db.insert(
                        "docs",
                        {"id": i, "n": i, "emb": rng.standard_normal(8).tolist()},
                    )
                    if i % 7 == 0:
                        db.delete_by_pk("docs", i - 3)
                    i += 1
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=searcher, args=(s,)) for s in range(8)]
        threads.append(threading.Thread(target=writer))
        for x in threads:
            x.start()
        time.sleep(1.0)
        stop.set()
        for x in threads:
            x.join(10)
        assert not errors, errors


class TestBoundedStalenessFlush:
    """Searches skip a CONTENDED vector flush (bounded staleness,
    reference async writeChanges) instead of convoying the engine; a
    deferred flush never surfaces committed deletes, and the row/age
    bounds force a blocking flush."""

    def test_deferred_flush_hides_pending_deletes(self, db):
        eng = db.engine
        t = eng._table("docs")
        idx = t.vector_indexes["emb"]
        in_search = threading.Event()
        release = threading.Event()
        real = type(idx).search

        def parked(self, *a, **kw):
            in_search.set()
            release.wait(5)
            return real(self, *a, **kw)

        type(idx).search = parked
        try:
            target = db.vector_search(  # resolves a real pk to delete
                "docs", "emb", np.zeros(8, np.float32), top_k=1
            )[0].primary_key
            th = threading.Thread(
                target=lambda: db.vector_search(
                    "docs", "emb", np.zeros(8, np.float32), top_k=3
                )
            )
            th.start()
            assert in_search.wait(5)
            # committed delete while a search holds shared mode: the next
            # search must NOT block on the flush and must NOT return the
            # deleted row
            db.delete_by_pk("docs", target)
            type(idx).search = real  # only the parked thread stays parked
            t0 = time.perf_counter()
            hits = db.vector_search(
                "docs", "emb", np.zeros(8, np.float32), top_k=5
            )
            took = time.perf_counter() - t0
            assert took < 2.0  # did not wait for the parked reader
            assert all(h.primary_key != target for h in hits)
            assert eng._counters.get("vector_flush_deferred", 0) >= 1
        finally:
            release.set()
            type(idx).search = real
            th.join(10)

    def test_age_bound_forces_flush(self, db, monkeypatch):
        eng = db.engine
        t = eng._table("docs")
        db.insert("docs", {"id": 7777, "n": 7777, "emb": [0.5] * 8})
        # pretend the pending batch is old: the bound must force a
        # blocking flush even under contention
        monkeypatch.setattr(
            type(t), "vec_pending_age", lambda self, f: 99.0
        )
        db.vector_search("docs", "emb", np.zeros(8, np.float32), top_k=1)
        assert t.vec_pending_count("emb") == 0

    def test_uncontended_search_still_flushes_eagerly(self, db):
        t = db.engine._table("docs")
        db.insert("docs", {"id": 8888, "n": 8888, "emb": [0.9] * 8})
        assert t.vec_pending_count("emb") > 0
        hits = db.vector_search(
            "docs", "emb", np.asarray([0.9] * 8, np.float32), top_k=1
        )
        assert hits[0].primary_key == 8888  # fresh row visible
        assert t.vec_pending_count("emb") == 0


class TestBackgroundVectorFlush:
    """run_vector_flush (crontab VECTOR_FLUSH_EVERY_S) drains buffered
    index writes asynchronously — the reference's writeChanges runs on
    its background write scheduler — so write-only workloads settle
    without a search tripping the staleness bounds."""

    def test_drains_pending_without_search(self, db):
        t = db.engine._table("docs")
        db.insert("docs", {"id": 9100, "n": 9100, "emb": [0.1] * 8})
        assert t.vec_pending_count("emb") > 0
        assert db.engine.run_vector_flush() == 1
        assert t.vec_pending_count("emb") == 0
        hits = db.vector_search(
            "docs", "emb", np.asarray([0.1] * 8, np.float32), top_k=1
        )
        assert hits[0].primary_key == 9100

    def test_skips_contended_index(self, db):
        t = db.engine._table("docs")
        idx = t.vector_indexes["emb"]
        db.insert("docs", {"id": 9200, "n": 9200, "emb": [0.2] * 8})
        done = {}

        def hold_shared():  # a foreign reader mid-dispatch
            lk = rw(idx)
            lk.acquire_read()
            try:
                done["n"] = db.engine.run_vector_flush()
            finally:
                lk.release_read()

        th = threading.Thread(target=hold_shared)
        th.start()
        th.join(10)
        assert done["n"] == 0  # contended: deferred to the next tick
        assert t.vec_pending_count("emb") > 0
        assert db.engine.run_vector_flush() == 1  # uncontended: drains

    def test_crontab_drains_within_staleness_window(self, db):
        t = db.engine._table("docs")
        db.insert("docs", {"id": 9300, "n": 9300, "emb": [0.3] * 8})
        assert t.vec_pending_count("emb") > 0
        deadline = time.time() + 10.0
        while time.time() < deadline and t.vec_pending_count("emb"):
            time.sleep(0.2)
        assert t.vec_pending_count("emb") == 0  # drained with NO search


# --- background retrain / compaction through the engine -----------------------


def _ivf_schema(dims=16, extra=()):
    return TableSchema(
        name="docs",
        fields=(*extra, FieldSchema("emb", DataType.vector,
                                    vector_config=VectorFieldConfig(dimensions=dims))),
        indexes=(IndexSchema(fields=("emb",), type="vector",
                             vector_config=VectorIndexConfig(
                                 index_type="ivf", metric="l2", num_clusters=8, nprobe=8)),),
    )


def _index_of(db):
    t = [v for k, v in db.engine._tables.items() if k[1] == "docs"][0]
    return next(iter(t.vector_indexes.values()))


class TestBackgroundMaintenance:
    def test_engine_background_retrain(self):
        db = ToStoreTPU.memory(schemas=[_ivf_schema()], device="cpu")
        try:
            rng = np.random.default_rng(0)
            x = rng.standard_normal((2400, 16)).astype(np.float32)
            db.batch_insert("docs", [
                {"id": i + 1, "emb": x[i].tolist()} for i in range(300)
            ])
            # searches flush but DON'T train engine-owned indexes (exact
            # flat scan until background maintenance builds)
            hit0 = db.vector_search("docs", "emb", x[0], top_k=1)[0]
            assert hit0.primary_key == 1
            vi = _index_of(db)
            assert vi.defer_retrain and not vi.trained
            assert db.engine.run_vector_maintenance() == 1  # initial build
            assert vi.trained
            db.batch_insert("docs", [
                {"id": i + 1, "emb": x[i].tolist()} for i in range(300, 2400)
            ])
            db.vector_search("docs", "emb", x[0], top_k=1)  # flush (no stall)
            assert vi.needs_retrain()
            assert db.engine.run_vector_maintenance() == 1
            assert not vi.needs_retrain()
            assert db.engine._counters["background_retrains"] == 2
            hit = db.vector_search("docs", "emb", x[1234], top_k=1)[0]
            assert hit.primary_key == 1235
        finally:
            db.close()

    def test_engine_background_compaction(self):
        db = ToStoreTPU.memory(schemas=[_ivf_schema()], device="cpu")
        try:
            rng = np.random.default_rng(1)
            x = rng.standard_normal((800, 16)).astype(np.float32)
            db.batch_insert("docs", [
                {"id": i + 1, "emb": x[i].tolist()} for i in range(800)
            ])
            db.vector_search("docs", "emb", x[0], top_k=1)  # flush
            assert db.engine.run_vector_maintenance() == 1  # initial build
            for pk in range(1, 300):
                db.delete_by_pk("docs", pk)
            db.vector_search("docs", "emb", x[300], top_k=1)  # flush deletes
            vi = _index_of(db)
            assert vi.needs_compact(0.10)
            assert db.engine.run_vector_maintenance() == 1
            assert vi.corpus.deleted_count == 0
            assert db.engine._counters["background_compactions"] == 1
            hit = db.vector_search("docs", "emb", x[500], top_k=1)[0]
            assert hit.primary_key == 501
        finally:
            db.close()

    def test_filter_update_invalidates_inflight_build(self):
        # a filter-only record update flushed during an off-lock compaction
        # build must invalidate the capture (the swapped-in filter columns
        # would otherwise predate the update)
        db = ToStoreTPU.memory(
            schemas=[_ivf_schema(8, (FieldSchema("views", DataType.integer),))], device="cpu")
        try:
            rng = np.random.default_rng(2)
            x = rng.standard_normal((600, 8)).astype(np.float32)
            db.batch_insert("docs", [
                {"id": i + 1, "views": 0, "emb": x[i].tolist()}
                for i in range(600)
            ])
            db.vector_search("docs", "emb", x[0], top_k=1)  # flush
            assert db.engine.run_vector_maintenance() == 1  # train
            for pk in range(1, 100):
                db.delete_by_pk("docs", pk)
            db.vector_search("docs", "emb", x[0], top_k=1)  # flush deletes
            vi = _index_of(db)
            cap = vi.capture_compact_state()
            shadow = vi.build_compacted(cap)
            # concurrent filter-only update + flush while the build ran
            db.update_by_pk("docs", 500, {"views": 9})
            db.vector_search("docs", "emb", x[0], top_k=1)  # flush filters
            assert not vi.install_compacted(cap, shadow)  # stale capture
            # the filter value survived and hybrid search sees it
            res = db.vector_search(
                "docs", "emb", x[499], top_k=1,
                condition=QueryCondition().where("views", "=", 9),
            )
            assert res and res[0].primary_key == 500
        finally:
            db.close()

    def test_search_during_offlock_retrain(self):
        """Searches and writes proceed while a retrain builds its shadow
        off-lock; the write makes the install refuse, the next tick
        retrains."""
        db = ToStoreTPU.memory(schemas=[_ivf_schema()], device="cpu")
        try:
            rng = np.random.default_rng(3)
            x = rng.standard_normal((900, 16)).astype(np.float32)
            db.batch_insert("docs", [{"id": i + 1, "emb": x[i]} for i in range(800)])
            db.vector_search("docs", "emb", x[0], top_k=1)
            vi = _index_of(db)
            real = type(vi).build_retrained
            building, release = threading.Event(), threading.Event()

            def slow_build(self, cap):
                building.set()
                release.wait(5)
                return real(self, cap)

            type(vi).build_retrained = slow_build
            done = {}
            th = threading.Thread(
                target=lambda: done.setdefault("n", db.engine.run_vector_maintenance()))
            try:
                th.start()
                assert building.wait(5)
                assert db.vector_search("docs", "emb", x[5], top_k=1)[0].primary_key == 6
                db.insert("docs", {"id": 801, "emb": x[800]})
                assert db.vector_search("docs", "emb", x[800], top_k=1)[0].primary_key == 801
            finally:
                release.set()
                th.join(10)
                type(vi).build_retrained = real
            assert done["n"] == 0 and not vi.trained  # the index mutated: refused
            assert db.engine.run_vector_maintenance() == 1 and vi.trained
            assert db.vector_search("docs", "emb", x[800], top_k=1)[0].primary_key == 801
        finally:
            db.close()


# --- what the port adds to the engine --------------------------------------


class TestPortDevice:
    def test_device_reaches_the_indexes(self, db):
        assert db.engine.config.device == "cpu"
        t = db.engine._table("docs")
        assert t.device == torch.device("cpu")
        assert t.vector_indexes["emb"].corpus.vectors.device.type == "cpu"
        assert db.status.memory().get("hbm_limit") is None  # a CPU device reports none

    def test_default_device_is_the_card(self):
        from tostore_tpu_torch import DataStoreConfig

        assert DataStoreConfig().device == "cuda"
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default opens on it")
        # a vector index on the default device without a card: torch's own
        # error, and nothing carries on on the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            ToStoreTPU.memory(schemas=[_vec_schema()])

    @pytest.mark.parametrize("shape", [(2,), (2, 2), (1, 4)])
    def test_mesh_raises_named_error(self, shape):
        """What raises, by name, is a mesh of more cards than the machine
        has; a mesh on a device that exists builds the sharded index."""
        # a mesh builds the sharded index (parallel/), every cell on the
        # device the config names with an index or as "cpu" ...
        d = ToStoreTPU.memory(schemas=[_vec_schema()], device="cpu", mesh_shape=shape)
        try:
            vi = d.engine._table("docs").vector_indexes["emb"]
            assert vi.index_type == "sharded_flat" and vi.nsh == shape[-1]
            assert len(d.engine._mesh.devices.flat) == int(np.prod(shape))
            assert all(c.device.type == "cpu" for c in d.engine._mesh.devices.flat)
            d.insert("docs", {"id": 7, "n": 7, "emb": [1.0] * 8})
            assert d.vector_search("docs", "emb", np.ones(8, np.float32),
                                   top_k=1)[0].primary_key == 7
        finally:
            d.close()
        # ... while "cuda" asks for one card a cell: with fewer cards the
        # error names them, and nothing is built on the CPU in their place
        if torch.cuda.device_count() < int(np.prod(shape)):
            with pytest.raises(RuntimeError, match="cards"):
                ToStoreTPU.memory(schemas=[_vec_schema()], device="cuda", mesh_shape=shape)

    @pytest.mark.parametrize("shape", [(), (1,), (1, 1)])
    def test_one_device_mesh_is_single_device(self, shape):
        d = ToStoreTPU.memory(schemas=[_vec_schema()], device="cpu", mesh_shape=shape)
        assert d.engine._mesh is None
        d.close()

    def test_table_refuses_a_mesh(self):
        """A table takes a mesh whose cells exist (sharded indexes, new or
        restored) and refuses only one of cards that are not there."""
        from tostore_tpu_torch.engine.table import Table, _index_from_state
        from tostore_tpu_torch.parallel import make_mesh

        # a table takes the mesh it is given: sharded indexes, new or restored
        mesh = make_mesh(4, dp=2, devices=["cpu"] * 4)
        t = Table(_vec_schema(), 0, mesh, device="cpu")
        assert t.vector_indexes["emb"].index_type == "sharded_flat" and t.mesh is mesh
        x = np.random.default_rng(2).standard_normal((40, 8)).astype(np.float32)
        single = ToStoreTPU.memory(schemas=[_vec_schema()], device="cpu")
        single.batch_insert("docs", [{"id": i, "n": i, "emb": x[i]} for i in range(40)])
        single.vector_search("docs", "emb", x[0], top_k=1)
        state = single.engine._table("docs").vector_indexes["emb"].state_dict()
        single.close()
        vi = _index_from_state(state, mesh, device="cpu")
        assert vi.index_type == "sharded_flat" and len(vi) == 40
        assert vi.search(x[9], top_k=1)[0].primary_key == 9
        # what it refuses is a mesh of cards that are not there
        if torch.cuda.device_count() < 4:
            with pytest.raises(RuntimeError, match="cards"):
                make_mesh(4)

    def test_profile_trace_writes_a_chrome_trace(self, db, tmp_path):
        with db.profile_trace(str(tmp_path / "trace")):
            db.vector_search("docs", "emb", np.zeros(8, np.float32), top_k=1)
        files = list((tmp_path / "trace").glob("trace_*.json"))
        assert len(files) == 1 and files[0].stat().st_size > 0

    def test_prewarm_on_open(self):
        d = ToStoreTPU.memory(schemas=[_vec_schema()], device="cpu", prewarm_on_open=True)
        d.engine._prewarm_thread.join(10)
        d.insert("docs", {"id": 1, "n": 1, "emb": [1.0] * 8})
        d.prewarm()
        assert d.vector_search("docs", "emb", np.ones(8, np.float32), top_k=1)[0].primary_key == 1
        d.close()

    def test_launch_counter_under_threads(self):
        from tostore_tpu_torch.ops import _kernels

        import sys

        counts = {"k": 0}
        threads = [threading.Thread(
            target=lambda: [_kernels.count(counts, "k") for _ in range(2000)]) for _ in range(16)]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)  # switch threads inside the read-add-write
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(30)
        finally:
            sys.setswitchinterval(old)
        assert not any(th.is_alive() for th in threads) and counts["k"] == 32000

    def test_sharded_snapshot_opens_on_one_device(self):
        """A state written by the JAX package's sharded indexes restores as
        a single-device index (flat and IVF, bf16 and int8)."""
        from tostore_tpu_torch.engine.table import _index_from_state
        from tostore_tpu_torch.utils.bf16 import BF16Array

        rng = np.random.default_rng(5)
        x = rng.standard_normal((600, 128)).astype(np.float32)
        bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
        base = {"dims": 128, "metric": "l2", "pks": list(range(600)), "filter_columns": {}}
        flat = _index_from_state({**base, "type": "sharded_flat", "precision": "bfloat16",
                                  "vectors": BF16Array(bits)}, device="cpu")
        assert flat.index_type == "flat" and len(flat) == 600
        assert flat.search(x[7], top_k=1)[0].primary_key == 7
        scales = (np.abs(x).max(axis=1) / 127.0).astype(np.float32)
        codes = np.round(x / scales[:, None]).astype(np.int8)
        ivf = _index_from_state({**base, "type": "sharded_ivf", "precision": "int8",
                                 "vectors": codes, "scales": scales, "num_clusters_cfg": 4,
                                 "nprobe": 4, "centroids": x[:4].copy(), "trained_size": 600},
                                device="cpu")
        assert ivf.index_type == "ivf" and ivf.trained and ivf.defer_retrain
        assert ivf.search(x[9], top_k=1)[0].primary_key == 9
