"""Engine-integrated mesh-sharded vector indexes on the port: the cases of
tests/test_engine_sharded.py run on `tostore_tpu_torch.ToStoreTPU` with
`device="cpu"` and a `mesh_shape` (every cell on the CPU, where the kernel
wrappers run their plain versions), and the cross-open: a file database
written under `mesh_shape=(4,)` by one package opens in the other under
(4,), (2, 2) and (), with the same primary keys from `vector_search`, in
the same order (distances within rtol 1e-4 / atol 1e-4, the bound of
tests/test_torch_engine_crossopen.py: f32 sums in another order).
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import tostore_tpu as R
import tostore_tpu_torch as T
from tostore_tpu_torch import (
    DataStoreConfig,
    DataType,
    FieldSchema,
    IndexSchema,
    TableSchema,
    ToStoreTPU,
    VectorFieldConfig,
)
from tostore_tpu_torch.models.schema import VectorIndexConfig, VectorIndexType

torch.set_num_threads(1)


def docs_schema(dims=32):
    return TableSchema(
        name="docs",
        fields=(
            FieldSchema("views", DataType.integer, default_value=0),
            FieldSchema("title", DataType.text),
            FieldSchema(
                "emb", DataType.vector, vector_config=VectorFieldConfig(dimensions=dims)
            ),
        ),
        indexes=(IndexSchema(fields=("emb",), type="vector"),),
    )


def _ivf_schema(dims=32, **index):
    index = {"index_type": VectorIndexType.ivf, "num_clusters": 8, "nprobe": 8, **index}
    return dataclasses.replace(
        docs_schema(dims),
        indexes=(IndexSchema(fields=("emb",), type="vector",
                             vector_config=VectorIndexConfig(**index)),),
    )


def _cfg(shape=(2, 4), **kw):
    return DataStoreConfig(mesh_shape=shape, device="cpu", **kw)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def db():
    d = ToStoreTPU(_cfg(), schemas=[docs_schema()])  # dp=2, shard=4
    yield d
    d.close()


class TestShardedEngine:
    def test_index_is_sharded(self, db, rng):
        t = db.engine._table("docs")
        vi = t.vector_indexes["emb"]
        assert vi.index_type == "sharded_flat"
        assert vi.nsh == 4 and vi.mesh.shape == {"dp": 2, "shard": 4}
        assert vi.corpus is vi and vi.device == torch.device("cpu")

    def test_search_and_mutation(self, db, rng):
        vecs = rng.standard_normal((300, 32)).astype(np.float32)
        db.batch_insert(
            "docs",
            [{"title": f"d{i}", "views": i, "emb": vecs[i].tolist()} for i in range(300)],
        )
        hit = db.vector_search("docs", "emb", vecs[42], top_k=1)[0]
        assert hit.primary_key == 43
        db.delete_by_pk("docs", 43)
        hit = db.vector_search("docs", "emb", vecs[42], top_k=1)[0]
        assert hit.primary_key != 43

    def test_hybrid_device_filter_on_mesh(self, db, rng):
        vecs = rng.standard_normal((200, 32)).astype(np.float32)
        db.batch_insert(
            "docs",
            [{"title": f"d{i}", "views": i, "emb": vecs[i].tolist()} for i in range(200)],
        )
        res = (
            db.vector_query("docs", "emb", vecs[10]).where("views", ">=", 100).top_k(5).fetch()
        )
        assert res
        for r in res:
            assert db.get_by_pk("docs", r.primary_key)["views"] >= 100
        # the mask came from the device columns, not from the host fallback
        fc = db.engine._table("docs").vector_indexes["emb"].filter_columns
        assert "views" in fc.names()

    def test_hybrid_filter_survives_growth(self, rng):
        """Rows re-striped by growth keep their filter values (the JAX
        package's sharded index does not move them, ROADMAP.md queue 3, so
        this case has no counterpart in its tests)."""
        d = ToStoreTPU(_cfg((4,)), schemas=[docs_schema()])
        try:
            vecs = rng.standard_normal((9000, 32)).astype(np.float32)
            for a, b in ((0, 3000), (3000, 9000)):
                d.batch_insert("docs", [{"title": f"d{i}", "views": i, "emb": vecs[i].tolist()}
                                        for i in range(a, b)])
                d.vector_search("docs", "emb", vecs[0], top_k=1)  # flush this batch
            assert d.engine._table("docs").vector_indexes["emb"].capacity > 8192
            for i in (10, 800, 2999, 5000):
                res = (d.vector_query("docs", "emb", vecs[i]).where("views", "=", i)
                       .top_k(3).fetch())
                assert [r.primary_key for r in res] == [i + 1]
        finally:
            d.close()

    def test_hybrid_host_fallback_on_mesh(self, db, rng):
        vecs = rng.standard_normal((200, 32)).astype(np.float32)
        db.batch_insert(
            "docs",
            [{"title": f"d{i}", "views": i, "emb": vecs[i].tolist()} for i in range(200)],
        )
        # a text predicate does not compile to device columns
        res = db.vector_query("docs", "emb", vecs[10]).where("title", "=", "d150").top_k(5).fetch()
        assert [r.primary_key for r in res] == [151]

    def test_durability_across_mesh_restart(self, tmp_path, rng):
        db = ToStoreTPU(_cfg(db_path=str(tmp_path)), schemas=[docs_schema()])
        vecs = rng.standard_normal((100, 32)).astype(np.float32)
        db.batch_insert("docs", [{"title": f"d{i}", "emb": vecs[i].tolist()} for i in range(100)])
        db.flush()
        db.close()
        # reopen on a DIFFERENT mesh shape (re-striping)
        db2 = ToStoreTPU(_cfg((1, 8), db_path=str(tmp_path)))
        assert db2.engine._table("docs").vector_indexes["emb"].nsh == 8
        hit = db2.vector_search("docs", "emb", vecs[7], top_k=1)[0]
        assert hit.primary_key == 8
        db2.close()
        # and back to a single device
        db3 = ToStoreTPU(DataStoreConfig(db_path=str(tmp_path), device="cpu"))
        idx = db3.engine._table("docs").vector_indexes["emb"]
        assert idx.index_type == "flat"
        hit = db3.vector_search("docs", "emb", vecs[7], top_k=1)[0]
        assert hit.primary_key == 8
        db3.close()

    def test_sharded_ivf_via_engine(self, rng):
        db = ToStoreTPU(_cfg(), schemas=[_ivf_schema()])
        t = db.engine._table("docs")
        assert t.vector_indexes["emb"].index_type == "sharded_ivf"
        nc = 8
        centers = rng.standard_normal((nc, 32)).astype(np.float32) * 4
        n = 5000
        vecs = (centers[np.arange(n) % nc] + rng.standard_normal((n, 32)) * 0.5).astype(
            np.float32
        )
        db.batch_insert(
            "docs",
            [{"title": f"d{i}", "views": i, "emb": vecs[i].tolist()} for i in range(n)],
        )
        hit = db.vector_search("docs", "emb", vecs[321], top_k=1)[0]
        assert hit.primary_key == 322
        assert t.vector_indexes["emb"].trained
        # hybrid on sharded ivf
        res = (
            db.vector_query("docs", "emb", vecs[321]).where("views", ">=", 2500).top_k(5).fetch()
        )
        assert res
        for r in res:
            assert db.get_by_pk("docs", r.primary_key)["views"] >= 2500
        # nprobe and mode reach the sharded index
        assert db.vector_search("docs", "emb", vecs[9], top_k=1, nprobe=2)[0].primary_key == 10
        assert db.vector_search("docs", "emb", vecs[9], top_k=1, mode="exact")[0].primary_key == 10
        db.close()

    def test_sharded_ivf_compact_preserves_config(self, rng):
        from tostore_tpu_torch.parallel import make_mesh
        from tostore_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

        mesh = make_mesh(8, dp=2, devices=["cpu"] * 8)
        idx = ShardedIVFIndex(16, mesh, metric="l2", num_clusters=8, nprobe=5,
                              min_train_size=500)
        x = rng.standard_normal((1200, 16)).astype(np.float32)
        idx.upsert(list(range(1200)), x)
        assert idx.trained and idx.nprobe == 5
        idx.delete(list(range(200)))
        assert idx.maybe_compact(0.10)
        # config + training survive the background-compaction path
        assert idx.nprobe == 5 and idx.num_clusters_cfg == 8 and idx.trained
        assert idx.search(x[777], top_k=1, nprobe=8)[0].primary_key == 777

    def test_ivf_snapshot_crosses_topologies(self, tmp_path, rng):
        schema = _ivf_schema(index_type="ivf", nprobe=6)
        db = ToStoreTPU(_cfg(db_path=str(tmp_path)), schemas=[schema])
        vecs = rng.standard_normal((5000, 32)).astype(np.float32)
        db.batch_insert("docs", [{"title": f"d{i}", "emb": vecs[i].tolist()} for i in range(5000)])
        db.vector_search("docs", "emb", vecs[0], top_k=1)  # flush + train
        assert db.engine._table("docs").vector_indexes["emb"].trained
        db.flush()
        db.close()
        # reopen single-device: stays IVF with config intact
        db2 = ToStoreTPU(DataStoreConfig(db_path=str(tmp_path), device="cpu"))
        idx = db2.engine._table("docs").vector_indexes["emb"]
        assert idx.index_type == "ivf" and idx.nprobe == 6 and idx.trained
        assert db2.vector_search("docs", "emb", vecs[42], top_k=1)[0].primary_key == 43
        db2.flush()
        db2.close()
        # and back onto a mesh
        db3 = ToStoreTPU(_cfg((1, 8), db_path=str(tmp_path)))
        idx = db3.engine._table("docs").vector_indexes["emb"]
        assert idx.index_type == "sharded_ivf" and idx.nprobe == 6 and idx.trained
        assert db3.vector_search("docs", "emb", vecs[42], top_k=1)[0].primary_key == 43
        db3.close()

    def test_compaction_restripes(self, db, rng):
        vecs = rng.standard_normal((120, 32)).astype(np.float32)
        db.batch_insert("docs", [{"title": f"d{i}", "emb": vecs[i].tolist()} for i in range(120)])
        db.engine._table("docs").flush_vectors()
        idx = db.engine._table("docs").vector_indexes["emb"]
        db.delete("docs").where("id", "<=", 30).execute()
        db.engine._table("docs").flush_vectors()
        assert idx.deleted_count == 30
        assert idx.maybe_compact(0.10)
        assert idx.deleted_count == 0 and len(idx) == 90
        hit = db.vector_search("docs", "emb", vecs[99], top_k=1)[0]
        assert hit.primary_key == 100

    def test_status_and_migration_over_a_mesh(self, db, rng):
        vecs = rng.standard_normal((50, 32)).astype(np.float32)
        db.batch_insert("docs", [{"title": f"d{i}", "emb": vecs[i].tolist()} for i in range(50)])
        db.vector_search("docs", "emb", vecs[0], top_k=1)
        info = db.engine.status()["tables"]["default/docs"]["vector_indexes"]["emb"]
        assert info == {"type": "sharded_flat", "count": 50, "deleted_ratio": 0.0}
        # a migration that changes the vector width rebuilds on the table's mesh
        new = dataclasses.replace(docs_schema(16), name="docs")
        from tostore_tpu_torch.engine.table import _make_vector_index

        t = db.engine._table("docs")
        vi = _make_vector_index(16, "float32", new.vector_indexes()[0], t.mesh, device=t.device)
        assert vi.index_type == "sharded_flat" and vi.mesh is t.mesh


class TestShardedEngineMaintenance:
    """Engine-level background maintenance over mesh indexes: the 4x-growth
    retrain and tombstone compaction run through run_vector_maintenance
    (off-lock capture / build / install), never inline on the write path."""

    def _ivf_db(self):
        return ToStoreTPU(_cfg(), schemas=[_ivf_schema(16)])

    def test_background_retrain(self, rng):
        db = self._ivf_db()
        try:
            x = rng.standard_normal((2400, 16)).astype(np.float32)
            vi = db.engine._table("docs").vector_indexes["emb"]
            assert vi.index_type == "sharded_ivf"
            vi.min_train_size = 100  # train on the small initial batch
            db.batch_insert("docs", [
                {"title": f"d{i}", "emb": x[i].tolist()} for i in range(300)
            ])
            db.vector_search("docs", "emb", x[0], top_k=1)  # flush + train
            assert vi.defer_retrain and vi.trained
            db.batch_insert("docs", [
                {"title": f"d{i}", "emb": x[i].tolist()}
                for i in range(300, 2400)
            ])
            db.vector_search("docs", "emb", x[0], top_k=1)  # flush, no stall
            assert vi.needs_retrain()
            assert db.engine.run_vector_maintenance() == 1
            assert not vi.needs_retrain()
            assert db.engine._counters["background_retrains"] == 1
            hit = db.vector_search("docs", "emb", x[1234], top_k=1)[0]
            assert hit.primary_key == 1235
        finally:
            db.close()

    def test_background_compaction(self, rng):
        db = self._ivf_db()
        try:
            x = rng.standard_normal((800, 16)).astype(np.float32)
            vi0 = db.engine._table("docs").vector_indexes["emb"]
            vi0.min_train_size = 100  # train on the small initial batch
            db.batch_insert("docs", [
                {"title": f"d{i}", "views": i, "emb": x[i].tolist()} for i in range(800)
            ])
            db.vector_search("docs", "emb", x[0], top_k=1)
            for pk in range(1, 300):
                db.delete_by_pk("docs", pk)
            db.vector_search("docs", "emb", x[0], top_k=1)  # flush deletes
            vi = db.engine._table("docs").vector_indexes["emb"]
            assert vi.needs_compact(0.10)
            assert db.engine.run_vector_maintenance() == 1
            assert vi.deleted_count == 0
            assert db.engine._counters["background_compactions"] == 1
            hit = db.vector_search("docs", "emb", x[500], top_k=1)[0]
            assert hit.primary_key == 501
            # the filter columns moved with the rows
            res = db.vector_query("docs", "emb", x[500]).where("views", ">=", 600).top_k(3).fetch()
            assert res and all(db.get_by_pk("docs", r.primary_key)["views"] >= 600 for r in res)
        finally:
            db.close()


class TestShardedBackupRestore:
    def test_mesh_backup_restore_and_topology_migration(self, rng, tmp_path):
        """Backup a mesh-sharded engine, restore into another mesh engine
        AND into a single-device engine (cross-topology via backup)."""
        schema = _ivf_schema(16, pq_subspaces=8)
        x = rng.standard_normal((600, 16)).astype(np.float32)
        cfg = _cfg()
        db = ToStoreTPU.open(str(tmp_path / "db"), schemas=[schema], config=cfg)
        vi = db.engine._table("docs").vector_indexes["emb"]
        vi.min_train_size = 100
        db.batch_insert("docs", [
            {"id": i + 1, "title": f"d{i}", "emb": x[i].tolist()}
            for i in range(600)
        ])
        db.vector_search("docs", "emb", x[0], top_k=1)
        path = db.backup(str(tmp_path / "b.zip"))
        db.close()

        db2 = ToStoreTPU.open(str(tmp_path / "db2"), schemas=[schema], config=cfg)
        db2.restore(path)
        assert db2.vector_search("docs", "emb", x[42], top_k=1)[0].primary_key == 43
        assert db2.engine._table("docs").vector_indexes["emb"].index_type == "sharded_ivf"
        db2.close()

        db3 = ToStoreTPU.open(str(tmp_path / "db3"), schemas=[schema], device="cpu")
        db3.restore(path)
        assert db3.vector_search("docs", "emb", x[42], top_k=1)[0].primary_key == 43
        db3.close()


# --------------------------------------------------------------------------
# Cross-open: a sharded deployment written by one package opens in the other
# --------------------------------------------------------------------------

PACKAGES = {"reference": (R, {}), "port": (T, {"device": "cpu"})}
TABLES = ("bf16", "int8", "pq")
N = 700


def _schemas(p, d):
    def table(name, prec, **index):
        return p.TableSchema(
            name=name,
            fields=(p.FieldSchema("price", p.DataType.double),
                    p.FieldSchema("emb", p.DataType.vector, vector_config=p.VectorFieldConfig(
                        dimensions=d, precision=prec))),
            indexes=(p.IndexSchema(fields=("emb",), type="vector",
                                   vector_config=p.VectorIndexConfig(metric="l2", **index)),),
        )

    return [table("bf16", "bfloat16", index_type="flat"),
            table("int8", "int8", index_type="flat"),
            table("pq", "bfloat16", index_type="ivf", num_clusters=8, nprobe=8, pq_subspaces=8)]


def _searches(p, db, x):
    out = {}
    for t in TABLES:
        for i in (3, N - 5, 350):
            hs = db.vector_search(t, "emb", x[i] + np.float32(0.05), top_k=5)
            out[t, i] = ([h.primary_key for h in hs], [h.distance for h in hs])
        hs = db.vector_search(t, "emb", x[10] + np.float32(0.05), top_k=4,
                              condition=p.QueryCondition().where("price", ">=", 40.0))
        out[t, "filtered"] = ([h.primary_key for h in hs], [h.distance for h in hs])
    return out


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(23).standard_normal((N, 32)).astype(np.float32)


@pytest.fixture(scope="module", params=["reference", "port"])
def written(request, rows, tmp_path_factory):
    """A file database written under mesh_shape=(4,): three sharded tables,
    a trained IVF-PQ among them, deletes, one checkpoint."""
    p, kw = PACKAGES[request.param]
    path = tmp_path_factory.mktemp(f"sharded_{request.param}")
    db = p.ToStoreTPU.open(str(path), schemas=_schemas(p, 32), mesh_shape=(4,), **kw)
    recs = [{"price": float(i % 90), "emb": rows[i]} for i in range(N)]
    for t in TABLES:
        vi = db.engine._table(t).vector_indexes["emb"]
        assert vi.index_type.startswith("sharded_")
        if t == "pq":
            vi.min_train_size = 100
        assert db.batch_insert(t, recs).is_success
        db.delete_by_pk(t, N - 4)
        db.vector_search(t, "emb", rows[0], top_k=1)  # flush the staged vectors
    assert db.engine._table("pq").vector_indexes["emb"].pq is not None
    live = _searches(p, db, rows)
    db.flush()
    db.close()
    # what the writer itself answers after a restart: a sharded snapshot
    # holds the stored rows and no norms, so a restore takes the l2 norms
    # from the rounded (bf16 / int8) rows, in either package, and distances
    # move by that rounding against the live index; the rows found do not
    copy = tmp_path_factory.mktemp(f"reopened_{request.param}") / "db"
    shutil.copytree(path, copy)
    db = p.ToStoreTPU.open(str(copy), mesh_shape=(4,), **kw)
    want = _searches(p, db, rows)
    db.close()
    assert {k: v[0] for k, v in want.items()} == {k: v[0] for k, v in live.items()}
    return request.param, path, want


@pytest.mark.parametrize("shape", [(4,), (2, 2), ()], ids=["4", "2x2", "single"])
def test_sharded_database_opens_in_the_other_package(written, rows, tmp_path, shape):
    writer, path, want = written
    p, kw = PACKAGES["port" if writer == "reference" else "reference"]
    copy = tmp_path / "db"
    shutil.copytree(path, copy)
    db = p.ToStoreTPU.open(str(copy), mesh_shape=shape, **kw)
    try:
        for t in TABLES:
            vi = db.engine._table(t).vector_indexes["emb"]
            assert type(vi).__module__.startswith(p.__name__)
            kind = ("sharded_" if shape else "") + ("ivf" if t == "pq" else "flat")
            assert vi.index_type == kind and len(vi) == N - 1
            if t == "pq":
                assert vi.trained
        got = _searches(p, db, rows)
    finally:
        db.close()
    assert set(got) == set(want)
    for key in want:
        assert got[key][0] == want[key][0] and len(want[key][0]) > 0, (key, got[key], want[key])
        assert np.allclose(got[key][1], want[key][1], rtol=1e-4, atol=1e-4), key
