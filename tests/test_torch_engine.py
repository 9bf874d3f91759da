"""Differential test of the engine: one seeded script of operations runs on
`tostore_tpu.ToStoreTPU` (JAX, CPU, Pallas in interpret mode) and on
`tostore_tpu_torch.ToStoreTPU(device="cpu")`, each on its own file
database, and every value the facade returns is compared step by step.

Covered: schema declare, insert / batch_insert / upsert / batch_upsert /
update / delete, queries with conditions, order, limit, offset, select,
distinct, joins and aggregates, a transaction that commits and one that
rolls back, kv set / get / increment / remove, `vector_search` on a flat
bf16 index, an IVF index and an IVF-PQ index (before and after
`run_vector_maintenance` trains them), filtered search through the device
mask and through the host mask (a LIKE predicate), `update_schema`,
`flush`, writes that live only in the WAL, a hard drop of the handle,
reopen, and `close` + reopen.

Tolerances. Everything relational must be equal. Vector hits: primary keys
equal and in the same order; `distance` and `score` within rtol 1e-4 and
atol 1e-4 (bf16 and f32 corpora alike: products are exact in f32 on both
sides and only the order of summation differs; the same bound
tests/test_torch_ivf.py states for re-ranked distances). Queries are
never a stored row itself, whose l2 distance would be the sqrt of
cancellation noise. The two
packages draw k-means seeds differently, so the IVF tables probe all of
their clusters (nprobe = num_clusters) and the PQ table re-ranks every
row: the answers are then exact whatever the training found.
"""

import dataclasses
import enum
import shutil

import numpy as np
import pytest
import torch

import tostore_tpu
import tostore_tpu_torch

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
D = 32
N = 900


def _norm(v):
    """A facade value as plain Python, comparable across the packages."""
    if isinstance(v, enum.Enum):
        return v.name
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _norm(getattr(v, f.name)) for f in dataclasses.fields(v)
                if not f.name.startswith("_") and f.name != "tx_id"}
    if isinstance(v, dict):
        return {str(k): _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, np.ndarray):
        return [_norm(x) for x in v.tolist()]
    if isinstance(v, np.generic):
        return v.item()
    if hasattr(v, "records") and hasattr(v, "has_more"):  # QueryResult
        return {"records": _norm(list(v.records)), "has_more": v.has_more, "total": v.total}
    return v


def _hits(hs):
    return {"pks": [h.primary_key for h in hs],
            "distance": [float(h.distance) for h in hs],
            "score": [float(h.score) for h in hs],
            "records": _norm([h.record for h in hs])}


def _schemas(p):
    def vec_table(name, prec, **index):
        return p.TableSchema(
            name=name,
            fields=(
                p.FieldSchema("title", p.DataType.text),
                p.FieldSchema("price", p.DataType.double),
                p.FieldSchema("ts", p.DataType.integer),
                p.FieldSchema("emb", p.DataType.vector,
                              vector_config=p.VectorFieldConfig(dimensions=D, precision=prec)),
            ),
            indexes=(p.IndexSchema(fields=("emb",), type="vector",
                                   vector_config=p.VectorIndexConfig(metric="l2", **index)),),
        )

    users = p.TableSchema(
        name="users",
        fields=(
            p.FieldSchema("username", p.DataType.text, nullable=False, unique=True),
            p.FieldSchema("age", p.DataType.integer, min_value=0, max_value=200),
            p.FieldSchema("balance", p.DataType.double, default_value=0.0),
            p.FieldSchema("is_active", p.DataType.boolean, default_value=True),
            p.FieldSchema("tags", p.DataType.array),
            p.FieldSchema("profile", p.DataType.json),
        ),
        indexes=(p.IndexSchema(fields=("age",)),),
    )
    posts = p.TableSchema(
        name="posts",
        fields=(p.FieldSchema("user_id", p.DataType.integer),
                p.FieldSchema("title", p.DataType.text)),
        foreign_keys=(p.ForeignKeySchema("user_id", "users",
                                         on_delete=p.ForeignKeyAction.cascade),),
    )
    return [
        users, posts,
        vec_table("flat", "bfloat16", index_type="flat"),
        vec_table("ivf", "float32", index_type="ivf", num_clusters=8, nprobe=8),
        vec_table("pq", "bfloat16", index_type="ivf", num_clusters=8, nprobe=8,
                  pq_subspaces=8, pq_rerank=4096),
    ]


def _hard_drop(db):
    """A crash as the engine sees it: the WAL and the background jobs are
    cut, nothing is checkpointed, the handle is dropped without close()."""
    db.engine._wal.close()
    db.engine._crontab.stop()


def run_script(p, path, **kw):
    """The script. Returns {label: value}; the labels are the steps."""
    out = {}
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, D)).astype(np.float32)
    cond = p.QueryCondition

    def q(i):
        # never a stored row itself: a distance of ~0 is all cancellation
        # noise, and its sqrt and score would need a looser bound
        return x[i] + np.float32(0.05)

    db = p.ToStoreTPU.open(path, schemas=_schemas(p), **kw)

    # --- relational writes
    out["insert"] = _norm(db.insert("users", {"username": "alice", "age": 30, "tags": ["a"]}))
    out["insert_dup"] = _norm(db.insert("users", {"username": "alice"}))
    out["insert_bad"] = _norm(db.insert("users", {"username": "old", "age": 999}))
    out["batch_insert"] = _norm(db.batch_insert("users", [
        {"username": f"u{i}", "age": int(rng.integers(18, 80)), "balance": float(i),
         "is_active": bool(i % 3), "profile": {"n": i, "k": [i, str(i)]}}
        for i in range(60)]))
    out["upsert"] = _norm(db.upsert("users", {"id": 2, "username": "u0", "age": 19}))
    out["batch_upsert"] = _norm(db.batch_upsert("users", [
        {"id": 3, "username": "u1", "age": 21}, {"id": 500, "username": "late", "age": 50}]))
    out["update"] = _norm(db.update("users", {"balance": 7.5}).where("age", ">", 60).execute())
    out["update_no_cond"] = _norm(db.update("users", {"age": 1}).execute())
    out["update_by_pk"] = _norm(db.update_by_pk("users", 1, {"age": 31}))
    out["delete"] = _norm(db.delete("users").where("age", "<", 20).execute())
    out["delete_by_pk"] = _norm(db.delete_by_pk("users", 10))
    out["posts"] = _norm(db.batch_insert("posts", [
        {"user_id": 1 + (i % 7), "title": f"p{i}"} for i in range(30)]))
    out["fk_violation"] = _norm(db.insert("posts", {"user_id": 4242, "title": "x"}))
    out["cascade"] = _norm(db.delete_by_pk("users", 5))

    # --- queries
    out["count"] = db.count("users")
    out["get_by_pk"] = _norm(db.get_by_pk("users", 1))
    out["q_where_order"] = _norm(db.query("users").where("age", ">=", 40)
                                 .order_by("age").order_by("id").limit(7).fetch())
    out["q_offset_desc"] = _norm(db.query("users").order_by_desc("balance")
                                 .order_by("id").offset(5).limit(5).fetch())
    out["q_between_in"] = _norm(db.query("users").where_between("age", 25, 45)
                                .where_in("is_active", [True]).order_by("id").fetch())
    out["q_like_or"] = _norm(db.query("users").where_like("username", "u1%")
                             .or_where(lambda c: c.where("age", "=", 31))
                             .order_by("id").fetch())
    out["q_select_distinct"] = _norm(sorted(
        r["is_active"] for r in db.query("users").select("is_active").distinct().fetch()))
    out["q_join"] = _norm(db.query("posts").join("users", "user_id", "id")
                          .order_by("id").limit(6).fetch())
    out["q_left_join"] = _norm(db.query("users").left_join("posts", "id", "user_id")
                               .where("users.id", "<=", 4).order_by("users.id").fetch())
    out["q_agg"] = _norm(db.query("users").aggregate(
        p.Agg.count(alias="n"), p.Agg.sum("age", "total"), p.Agg.avg("balance", "avg_b"),
        p.Agg.min("age", "lo"), p.Agg.max("age", "hi")).fetch())
    out["q_group_having"] = _norm(sorted(
        db.query("users").group_by("is_active").aggregate(p.Agg.count(alias="n"))
        .having("n", ">", 1).fetch().records, key=lambda r: str(r["is_active"])))
    out["q_first_exists"] = _norm([db.query("users").where("age", ">", 70).order_by("id").first(),
                                   db.query("users").where("age", ">", 500).exists()])
    out["q_cursor"] = _norm((lambda a: [a, a.next()])(
        db.query("users").order_by("id").limit(4).fetch()))
    out["explain"] = _norm(db.query("users").where("age", "=", 31).explain())

    # --- transactions
    def commits(tx):
        db.insert("users", {"username": "tx_a", "age": 41})
        db.update_by_pk("users", 1, {"balance": 99.0})
        return "done"

    def rolls_back(tx):
        db.insert("users", {"username": "tx_b", "age": 42})
        db.delete_by_pk("users", 1)
        raise p.BusinessError("nope")

    out["txn_commit"] = _norm(db.transaction(commits))
    out["txn_rollback"] = _norm(db.transaction(rolls_back))
    out["txn_after"] = _norm([db.count("users"), db.get_by_pk("users", 1),
                              db.query("users").where("username", "=", "tx_b").exists()])

    # --- kv
    out["kv_set"] = _norm([db.kv.set("a", {"x": [1, 2.5, "s"]}), db.kv.set("n", 5),
                           db.set_value("g", "global", is_global=True)])
    out["kv_get"] = _norm([db.kv.get("a"), db.kv.get_int("n"), db.kv.set_increment("n", 3),
                           db.get_value("g", is_global=True), db.kv.get("missing", "dflt"),
                           sorted(db.kv.get_keys())])
    out["kv_remove"] = _norm([db.kv.remove("a"), db.kv.exists("a"), db.kv.count()])

    # --- vectors
    recs = [{"title": f"t{i % 17}", "price": float(i % 100), "ts": 1_700_000_000_000 + i,
             "emb": x[i]} for i in range(N)]
    for t in ("flat", "ivf", "pq"):
        out[f"vec_insert_{t}"] = _norm(db.batch_insert(t, recs))
    price = cond().where("price", ">", 50.0).where("ts", "<", 1_700_000_000_700)
    like = cond().where_like("title", "t1%")
    for t in ("flat", "ivf", "pq"):
        out[f"search_untrained_{t}"] = _hits(db.vector_search(t, "emb", q(7), top_k=8))
    out["maintenance"] = db.engine.run_vector_maintenance()
    out["trained"] = [db.engine._table(t).vector_indexes["emb"].trained for t in ("ivf", "pq")]
    for t in ("flat", "ivf", "pq"):
        out[f"search_{t}"] = _hits(db.vector_search(t, "emb", q(8), top_k=8))
        out[f"search_device_mask_{t}"] = _hits(
            db.vector_search(t, "emb", q(300), top_k=6, condition=price))
        out[f"search_host_mask_{t}"] = _hits(
            db.vector_search(t, "emb", q(300), top_k=6, condition=like, include_records=True))
        out[f"search_exact_threshold_{t}"] = _hits(
            db.vector_search(t, "emb", q(40), top_k=5, mode="exact", threshold=7.0))
    out["vector_query_builder"] = _hits(
        db.vector_query("flat", "emb", q(9)).top_k(4).where("price", "<=", 20.0).fetch())
    for t in ("flat", "ivf", "pq"):
        if t == "flat":
            # not on the IVF tables before the checkpoint: the reference's
            # IVF snapshot compacts a corpus with holes under its live
            # bucket layout (tostore_tpu/vector/ivf.py:1517-1533, a
            # reference fault that tests/test_torch_ivf.py pins); their
            # deletes come with the WAL tail below
            db.delete_by_pk(t, 8)
        db.update_by_pk(t, 9, {"emb": x[7] * np.float32(1.02), "price": 1.0})  # near pk 8, no tie
        out[f"search_after_write_{t}"] = _hits(db.vector_search(t, "emb", q(7), top_k=4))

    # --- schema migration
    out["update_schema"] = _norm(
        db.update_schema("users").add_field(p.FieldSchema("nickname", p.DataType.text, unique=True))
        .rename_field("age", "years").remove_field("profile").execute())
    out["after_migration"] = _norm([
        db.insert("users", {"username": "m1", "nickname": "nick", "years": 33}),
        db.insert("users", {"username": "m2", "nickname": "nick"}),
        db.query("users").where("years", ">", 70).order_by("id").limit(3).fetch()])

    # --- durability: checkpoint, a WAL tail, a hard drop, reopen
    out["flush"] = _norm(db.flush())
    tail = rng.standard_normal((40, D)).astype(np.float32)
    out["tail_writes"] = _norm([
        db.batch_insert("flat", [{"id": 5000 + i, "title": "tail", "price": 3.0, "ts": i,
                                  "emb": tail[i]} for i in range(40)]),
        [db.delete_by_pk(t, 20) for t in ("flat", "ivf", "pq")],
        db.insert("users", {"username": "tail", "years": 77}),
        db.kv.set("tail", 1)])
    before = {t: _hits(db.vector_search(t, "emb", tail[3] + np.float32(0.05), top_k=5)) for t in ("flat", "ivf", "pq")}
    _hard_drop(db)
    del db
    db = p.ToStoreTPU.open(path, schemas=None, **kw)
    out["recovered_entries"] = db.engine._counters["recovered_wal_entries"]
    for t in ("flat", "ivf", "pq"):
        got = _hits(db.vector_search(t, "emb", tail[3] + np.float32(0.05), top_k=5))
        assert got["pks"] == before[t]["pks"], (t, got, before[t])  # same package, same pks
        out[f"search_recovered_{t}"] = got
    out["recovered_rows"] = _norm([db.count("users"), db.count("flat"), db.kv.get("tail"),
                                   db.query("users").where("username", "=", "tail").fetch(),
                                   db.get_by_pk("flat", 20), db.get_by_pk("pq", 20)])
    db.close()
    db = p.ToStoreTPU.open(path, **kw)
    out["reopened_clean"] = _norm([
        db.engine._counters["recovered_wal_entries"], db.count("flat"), db.count("posts"),
        [db.engine._table(t).vector_indexes["emb"].trained for t in ("ivf", "pq")]])
    for t in ("flat", "ivf", "pq"):
        out[f"search_reopened_{t}"] = _hits(
            db.vector_search(t, "emb", q(300), top_k=6, condition=price))
    db.close()
    return out


LABELS = """insert insert_dup insert_bad batch_insert upsert batch_upsert update update_no_cond
update_by_pk delete delete_by_pk posts fk_violation cascade count get_by_pk q_where_order
q_offset_desc q_between_in q_like_or q_select_distinct q_join q_left_join q_agg q_group_having
q_first_exists q_cursor explain txn_commit txn_rollback txn_after kv_set kv_get kv_remove
vec_insert_flat vec_insert_ivf vec_insert_pq search_untrained_flat search_untrained_ivf
search_untrained_pq maintenance trained search_flat search_device_mask_flat search_host_mask_flat
search_exact_threshold_flat search_ivf search_device_mask_ivf search_host_mask_ivf
search_exact_threshold_ivf search_pq search_device_mask_pq search_host_mask_pq
search_exact_threshold_pq vector_query_builder search_after_write_flat search_after_write_ivf
search_after_write_pq update_schema after_migration flush tail_writes recovered_entries
search_recovered_flat search_recovered_ivf search_recovered_pq recovered_rows reopened_clean
search_reopened_flat search_reopened_ivf search_reopened_pq""".split()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("engine_diff")
    ref = run_script(tostore_tpu, str(root / "reference"))
    port = run_script(tostore_tpu_torch, str(root / "port"), device="cpu")
    yield ref, port
    shutil.rmtree(root, ignore_errors=True)


def test_script_runs_every_step(both):
    ref, port = both
    assert list(ref) == LABELS and list(port) == LABELS


def _close(a, b):
    return np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("label", LABELS)
def test_step_equal(both, label):
    ref, port = both
    r, t = ref[label], port[label]
    if isinstance(r, dict) and "pks" in r and "distance" in r:
        assert t["pks"] == r["pks"], (t, r)
        assert len(r["pks"]) > 0 or "threshold" in label
        assert _close(t["distance"], r["distance"]), (t["distance"], r["distance"])
        assert _close(t["score"], r["score"]), (t["score"], r["score"])
        r = {k: v for k, v in r.items() if k in ("records",)}
        t = {k: v for k, v in t.items() if k in ("records",)}
        # records carry the vectors as stored: equal floats, not bits of text
        assert _records_equal(t["records"], r["records"]), (t, r)
        return
    assert t == r, f"{label}: port {t!r} != reference {r!r}"


def _records_equal(a, b):
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if (ra is None) != (rb is None):
            return False
        if ra is None:
            continue
        if set(ra) != set(rb):
            return False
        for k in ra:
            if k == "emb":
                if not _close(ra[k], rb[k]):
                    return False
            elif ra[k] != rb[k]:
                return False
    return True
