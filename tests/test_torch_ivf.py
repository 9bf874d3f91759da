"""Port parity for the IVF slice as a whole: tostore_tpu_torch.IVFVectorIndex
against tostore_tpu.vector.IVFVectorIndex (mirrors TestIVF,
TestBackgroundRetrain and TestBackgroundCompaction of
tests/test_vector_indexes.py at library level, at small size).

Most cases train the JAX index, carry its state (corpus, centroids, PQ
codebooks) into the port through tostore_tpu_torch.convert, and compare
the layout the port rebuilds from it and then search_arrays on each of
the four probe paths: raw and PQ, each over the bucket-contiguous copy
(the kernels' plain versions here, Pallas in interpret mode on the JAX
side) and by gather. Both packages then see the same upserts, deletes and
compactions. Tolerances are those of tests/torch_parity.py (scores;
slot sets outside near-ties). Layouts must be identical, unless a row
sits on a near-tie between two centroids (then its two scores must agree
within 1e-4 relative). Deletes refill fewer than 64 freed slots at a time:
a larger contiguous refill trips the JAX package's fault at
tostore_tpu/vector/corpus.py:232-255 (ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch

from tostore_tpu.vector import IVFVectorIndex as JIVF
from tostore_tpu_torch import IVFVectorIndex as TIVF
from tostore_tpu_torch import convert
from torch_parity import TOL, assert_topk_match

torch.set_num_threads(1)

NEG_INF = float(np.finfo(np.float32).min)


def _clustered(seed, n=3000, d=64, nat=40):
    """The JAX package's hard clustered data: natural modes x3 + unit noise."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nat, d)).astype(np.float32) * 3
    x = (centers[rng.integers(0, nat, n)] + rng.standard_normal((n, d))).astype(np.float32)
    return x, rng


def _queries(rng, x, b=6):
    return (x[rng.integers(0, len(x), b)]
            + rng.standard_normal((b, x.shape[1])).astype(np.float32) * 0.1)


def _pair(metric, precision, seed=0, n=3000, d=64, c=16, nprobe=4, **kw):
    """(jax index trained by upsert, port index converted from its state,
    data, rng)."""
    x, rng = _clustered(seed, n, d)
    j = JIVF(d, metric, precision, num_clusters=c, nprobe=nprobe, min_train_size=100, **kw)
    j.upsert(list(range(n)), x)
    assert j.trained
    t = convert.ivf_index_from_reference(j.state_dict(), "cpu")
    return j, t, x, rng


def _assign_of(idx):
    """slot -> cluster of every placed slot, from the bucket matrix."""
    b = np.asarray(idx.buckets_slots)
    cl = np.asarray(idx._slice_cluster)
    out = {}
    for s in range(b.shape[0]):
        for slot in b[s][b[s] >= 0].tolist():
            out[slot] = int(cl[s])
    return out


def _assert_same_layout(t, j):
    """Identical bucket matrix; else every row placed differently must sit
    on a near-tie between its two clusters."""
    tb, jb = t.buckets_slots.numpy(), np.asarray(j.buckets_slots)
    if tb.shape == jb.shape and np.array_equal(tb, jb):
        np.testing.assert_array_equal(t._slice_cluster, j._slice_cluster)
        return
    ta, ja = _assign_of(t), _assign_of(j)
    assert set(ta) == set(ja)
    cents = t.centroids.double().numpy()
    moved = [s for s in ta if ta[s] != ja[s]]
    assert moved
    for s in moved:
        v = t._stored_matrix_f32(np.array([s])).double().numpy()[0]
        sc = v @ cents.T
        if t.metric == "l2":
            sc = 2 * sc - np.sum(cents * cents, axis=1)
        a, b = sc[ta[s]], sc[ja[s]]
        assert abs(a - b) <= 1e-4 * max(1.0, abs(a)), (s, a, b)


def _as_scores(metric, dist, q):
    qsq = np.sum(q.astype(np.float64) ** 2, axis=1)[:, None]
    if metric == "l2":
        s = np.where(np.isfinite(dist), qsq - dist.astype(np.float64) ** 2, NEG_INF)
    else:
        s = np.where(np.isfinite(dist), -dist.astype(np.float64), NEG_INF)
    return s


def _assert_search_match(t, j, q, k=10, mode="probe", nprobe=None):
    td, ts, tp = t.search_arrays(q, k, nprobe=nprobe, mode=mode)
    jd, js, jp = j.search_arrays(q, k, nprobe=nprobe, mode=mode)
    assert td.dtype == np.float32 and ts.dtype == np.int64 and tp.dtype == object
    assert td.shape == np.asarray(jd).shape
    dtype = t.corpus.precision
    assert_topk_match(_as_scores(t.metric, td, q), ts, _as_scores(t.metric, jd, q), js,
                      TOL[dtype])
    assert np.array_equal(ts < 0, np.asarray(js) < 0)
    for b in range(len(q)):
        for s, pk in zip(ts[b], tp[b]):
            assert (pk is None) == (s < 0)
            if s >= 0:
                assert t.corpus._slot_pks[s] == pk
    return ts


# ----------------------------------------------------------------------------
# layout and search parity on all four probe paths
# ----------------------------------------------------------------------------

PRECISIONS = ["float32", "bfloat16", "int8"]
METRICS = ["l2", "dot", "cosine"]


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("metric", METRICS)
def test_raw_probe_contig_and_gather(metric, precision):
    j, t, x, rng = _pair(metric, precision, seed=len(metric) + len(precision))
    _assert_same_layout(t, j)
    assert t.bucket_vectors is not None and j.bucket_vectors is not None
    assert t.bucket_vectors.dtype == t.corpus.dtype
    np.testing.assert_array_equal(t._bucket_counts_host(), j._bucket_counts_host())
    q = _queries(rng, x)
    _assert_search_match(t, j, q)  # K3 path
    _assert_search_match(t, j, q[:1], k=5, nprobe=7)
    # over the contiguous-copy budget: the row-gather path in both
    for idx in (t, j):
        idx.CONTIG_MAX_BYTES = 0
        idx._refresh_bucket_vectors()
        assert idx.bucket_vectors is None
    _assert_search_match(t, j, q)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("metric,m,kc", [("l2", 16, 0), ("dot", 8, 256), ("cosine", 16, 16)])
def test_pq_probe_contig_and_gather(metric, m, kc, precision):
    j, t, x, rng = _pair(metric, precision, seed=7 + m, pq_subspaces=m, pq_centroids=kc)
    _assert_same_layout(t, j)
    assert t.pq.k == j.pq.k and t._pack_nibbles == j._pack_nibbles
    np.testing.assert_array_equal(t.pq.codebooks.numpy(), np.asarray(j.pq.codebooks))
    codes_differ = np.argwhere(t.codes.numpy() != np.asarray(j.codes))
    assert len(codes_differ) <= 3  # near-ties of the residual encode only
    assert tuple(t.bucket_codes.shape) == tuple(j.bucket_codes.shape)
    q = _queries(rng, x)
    _assert_search_match(t, j, q)  # K4 path
    for idx in (t, j):
        idx.bucket_codes = None
    _assert_search_match(t, j, q)  # code-gather path


def test_unsupported_pq_shape_takes_gather_path():
    # M * K = 64 is not lane-aligned for the JAX kernel: both packages use
    # the gather path from the start
    j, t, x, rng = _pair("l2", "float32", seed=3, d=32, pq_subspaces=4, pq_centroids=16)
    assert t.bucket_codes is None and j.bucket_codes is None
    _assert_search_match(t, j, _queries(rng, x))


def test_sliced_layout_with_fat_clusters():
    # two modes and many centroids: first choices pile onto a few
    # clusters, which then span several slices with duplicated centroids;
    # the probe must pick the same slices as the JAX package (ties by
    # lower index)
    rng = np.random.default_rng(21)
    d, n = 16, 4000
    modes = rng.standard_normal((2, d)).astype(np.float32) * 10
    x = (modes[rng.integers(0, 2, n)] + rng.standard_normal((n, d))).astype(np.float32)
    j = JIVF(d, "l2", "bfloat16", num_clusters=32, nprobe=4, min_train_size=100)
    j.upsert(list(range(n)), x)
    t = convert.ivf_index_from_reference(j.state_dict(), "cpu")
    _assert_same_layout(t, j)
    assert t.buckets_slots.shape[0] > 32  # some cluster has several slices
    q = x[:5] + 0.01
    for nprobe in (1, 3, 4):
        _assert_search_match(t, j, q, k=10, nprobe=nprobe)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_train_parity(precision):
    # both packages train from the same data: same sample and init (numpy
    # RNG), bf16 Lloyd products, the same slices
    x, rng = _clustered(31, n=2500, d=32)
    kw = dict(num_clusters=16, nprobe=4, min_train_size=100)
    j = JIVF(32, "l2", precision, **kw)
    t = TIVF(32, "l2", precision, device="cpu", **kw)
    j.upsert(list(range(2500)), x)
    t.upsert(list(range(2500)), x)
    assert t.trained and t._trained_size == j._trained_size
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), atol=1e-4)
    _assert_same_layout(t, j)
    _assert_search_match(t, j, _queries(rng, x))


def test_train_parity_residual_pq():
    x, rng = _clustered(32, n=2500, d=32)
    kw = dict(num_clusters=16, nprobe=4, min_train_size=100, pq_subspaces=8)
    j = JIVF(32, "l2", "float32", **kw)
    t = TIVF(32, "l2", "float32", device="cpu", **kw)
    j.upsert(list(range(2500)), x)
    t.upsert(list(range(2500)), x)
    # the residuals differ by the centroids' last bits, which can flip a
    # near-tie inside one subspace's Lloyd loop and move that codebook;
    # the other subspaces agree within 1e-4
    diff = np.abs(t.pq.codebooks.numpy() - np.asarray(j.pq.codebooks)).max(axis=(1, 2))
    assert (diff > 1e-4).sum() <= 1, diff
    _assert_search_match(t, j, _queries(rng, x))


# ----------------------------------------------------------------------------
# mutation, flat fallback, persistence
# ----------------------------------------------------------------------------


def _mutate(idx, x, rng_seed):
    """Appends, overwrites, deletes and a refill of < 64 freed slots."""
    rng = np.random.default_rng(rng_seed)
    d = x.shape[1]
    idx.upsert(list(range(10_000, 10_200)), x[rng.integers(0, len(x), 200)]
               + rng.standard_normal((200, d)).astype(np.float32) * 0.2)
    idx.upsert(list(range(0, 40, 2)), x[100:120] + 0.05)  # overwrites: vacate + re-append
    idx.delete(list(range(500, 550)))
    idx.upsert(list(range(20_000, 20_030)), x[rng.integers(0, len(x), 30)] + 0.3)


@pytest.mark.parametrize("precision,pq", [("float32", 0), ("bfloat16", 0), ("int8", 0),
                                          ("bfloat16", 16)])
def test_append_delete_compact(precision, pq):
    j, t, x, rng = _pair("l2", precision, seed=41, pq_subspaces=pq)
    _mutate(j, x, 5)
    _mutate(t, x, 5)
    assert t.corpus.capacity == j.corpus.capacity and len(t) == len(j)
    np.testing.assert_array_equal(t.corpus._slot_pks, j.corpus._slot_pks)
    _assert_same_layout(t, j)
    q = np.concatenate([_queries(rng, x, 4), x[510:512], x[100:102] + 0.05])
    ts = _assert_search_match(t, j, q)
    dead = set(t.corpus.slots_for_pks(list(range(500, 550))).tolist())
    assert -1 in dead  # deleted pks have no slot; their old slots were reused or freed
    assert not {p for p in t.search_arrays(q, 10, mode="probe")[2].ravel()} & set(range(500, 550))
    assert ts.shape == (len(q), 10)
    t.compact()
    j.compact()
    assert t.corpus.capacity == j.corpus.capacity and t.corpus.deleted_count == 0
    _assert_same_layout(t, j)
    _assert_search_match(t, j, q)


def test_flat_fallback_and_exact_mode():
    j, t, x, rng = _pair("cosine", "float32", seed=5)
    q = _queries(rng, x)
    _assert_search_match(t, j, q, mode="exact")
    # below min_train_size the index stays untrained: flat scan
    small = TIVF(16, "cosine", device="cpu")
    xs = rng.standard_normal((20, 16)).astype(np.float32)
    small.upsert(list(range(20)), xs)
    assert not small.trained
    assert small.search(xs[3], top_k=1)[0].primary_key == 3
    empty = TIVF(8, "l2", device="cpu")
    d, s, p = empty.search_arrays(np.zeros((2, 8), np.float32), 3)
    assert np.isinf(d).all() and (s == -1).all()
    assert empty.search(np.zeros(8, np.float32)) == []


@pytest.mark.parametrize("metric", METRICS)
def test_single_query_search(metric):
    j, t, x, rng = _pair(metric, "float32", seed=61)
    q = _queries(rng, x, 1)[0]
    tr, jr = t.search(q, top_k=8), j.search(q, top_k=8)
    assert [r.primary_key for r in tr] == [r.primary_key for r in jr]
    np.testing.assert_allclose([r.distance for r in tr], [r.distance for r in jr],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose([r.score for r in tr], [r.score for r in jr],
                               rtol=1e-4, atol=1e-5)
    thr = (tr[2].distance + tr[3].distance) / 2
    assert len(t.search(q, top_k=8, threshold=thr)) == 3


@pytest.mark.parametrize("pq", [0, 16])
def test_state_dict_both_ways(pq):
    j, t, x, rng = _pair("l2", "bfloat16", seed=71, pq_subspaces=pq)
    t.delete(list(range(0, 3000, 97)))
    state = t.state_dict()  # compacts the port index (layout rebuilt)
    assert state["pq_residual"] is True and (state["pq"] is None) == (pq == 0)
    j2 = JIVF.from_state_dict(state)
    t2 = TIVF.from_state_dict(state, device="cpu")
    q = _queries(rng, x)
    _assert_same_layout(t2, j2)
    _assert_search_match(t2, j2, q)
    _assert_search_match(t, j2, q)  # the live port index stayed consistent
    back = convert.ivf_index_from_reference(j2.state_dict(), "cpu")
    _assert_search_match(back, j2, q)
    legacy = dict(state)
    legacy.pop("pq_residual")
    legacy.pop("pq_rerank")
    assert TIVF.from_state_dict(legacy, device="cpu").pq_residual is False


@pytest.mark.parametrize("precision,pq,pack", [
    ("bfloat16", 0, False), ("float32", 0, False), ("int8", 0, False),
    ("bfloat16", 192, True), ("bfloat16", 96, False),
])
def test_flat_beats_probe_decisions_match(precision, pq, pack):
    x = np.random.default_rng(0).standard_normal((300, 768)).astype(np.float32)
    kw = dict(num_clusters=8, nprobe=16, min_train_size=100, pq_subspaces=pq,
              pq_centroids=256 if pq == 96 else 0)
    j = JIVF(768, "l2", precision, **kw)
    t = TIVF(768, "l2", precision, device="cpu", **kw)
    for idx in (j, t):
        idx.upsert(list(range(300)), x)
        assert idx.trained and (idx.pq is not None) == bool(pq)
    assert t._pack_nibbles == j._pack_nibbles == pack
    for capacity in (0, 2048, 43_008, 262_144, 1_048_576, 4_194_304):
        for b in (1, 8, 32, 64, 128, 256, 1024):
            for nprobe in (4, 16, 64):
                j.corpus.capacity = t.corpus.capacity = capacity
                assert t._flat_beats_probe(b, nprobe) == j._flat_beats_probe(b, nprobe), \
                    (capacity, b, nprobe)


# ----------------------------------------------------------------------------
# RCU retrain and compaction (library level)
# ----------------------------------------------------------------------------


def test_capture_build_install_roundtrip():
    x = np.random.default_rng(42).standard_normal((2000, 32)).astype(np.float32)
    idx = TIVF(32, "l2", num_clusters=8, nprobe=8, min_train_size=100, device="cpu")
    idx.defer_retrain = True
    idx.upsert(list(range(400)), x[:400])
    assert not idx.trained and idx.needs_retrain()
    assert idx.search(x[77], top_k=1)[0].primary_key == 77  # flat fallback
    cap0 = idx.capture_build_state()
    assert idx.install_retrained(cap0, idx.build_retrained(cap0))
    assert idx.trained
    idx.upsert(list(range(400, 2000)), x[400:])  # 4x growth: deferred
    assert idx.needs_retrain()
    cap = idx.capture_build_state()
    assert idx.install_retrained(cap, idx.build_retrained(cap))
    assert not idx.needs_retrain()
    assert idx.search(x[77], top_k=1)[0].primary_key == 77


def test_rcu_retrain_matches_reference():
    x, rng = _clustered(81, n=2000, d=32)
    kw = dict(num_clusters=8, nprobe=4, min_train_size=100)
    j = JIVF(32, "l2", "bfloat16", **kw)
    t = TIVF(32, "l2", "bfloat16", device="cpu", **kw)
    for idx in (j, t):
        idx.defer_retrain = True
        idx.upsert(list(range(2000)), x)
        cap = idx.capture_build_state()
        assert idx.install_retrained(cap, idx.build_retrained(cap))
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), atol=1e-4)
    _assert_same_layout(t, j)
    _assert_search_match(t, j, _queries(rng, x))


@pytest.mark.parametrize("change", ["insert", "overwrite", "delete"])
def test_stale_install_rejected(change):
    # the port writes corpus tensors in place and does not clone them at
    # capture: any write between capture and install must refuse it
    x = np.random.default_rng(3).standard_normal((1200, 16)).astype(np.float32)
    idx = TIVF(16, "l2", num_clusters=8, nprobe=8, min_train_size=100, device="cpu")
    idx.defer_retrain = True
    idx.upsert(list(range(1200)), x)
    cap = idx.capture_build_state()
    before = idx.corpus.vectors[5].clone()
    if change == "insert":
        idx.upsert([99_999], x[:1])
    elif change == "overwrite":
        idx.upsert([5], x[6:7])
        assert not torch.equal(cap["vectors"][5], before)  # written in place
    else:
        idx.delete([5])
    shadow = idx.build_retrained(cap)
    assert not idx.install_retrained(cap, shadow)
    assert not idx.trained
    hits = idx.search(x[6], top_k=2)
    assert hits[0].primary_key in (5, 6) if change == "overwrite" else hits[0].primary_key == 6


def test_background_compaction():
    x = np.random.default_rng(4).standard_normal((2000, 16)).astype(np.float32)
    idx = TIVF(16, "l2", num_clusters=8, nprobe=8, min_train_size=100, device="cpu")
    idx.upsert(list(range(2000)), x)
    idx.defer_retrain = True
    idx.delete(list(range(0, 2000, 3)))
    assert idx.needs_compact(0.10)
    cap_before = idx.corpus.capacity
    cap = idx.capture_compact_state()
    assert idx.install_compacted(cap, idx.build_compacted(cap))
    assert idx.corpus.deleted_count == 0 and len(idx.corpus) == 2000 - 667
    assert idx.corpus.capacity <= cap_before
    assert idx.search(x[1], top_k=1)[0].primary_key == 1
    assert all(r.primary_key % 3 != 0 for r in idx.search(x[4], top_k=10))


def test_background_compaction_matches_reference():
    x, rng = _clustered(91, n=2000, d=32)
    j, t, _, _ = _pair("l2", "float32", seed=91, n=2000, d=32, c=8, pq_subspaces=8)
    for idx in (j, t):
        idx.delete(list(range(0, 2000, 4)))
        cap = idx.capture_compact_state()
        assert idx.install_compacted(cap, idx.build_compacted(cap))
    assert t.corpus.capacity == j.corpus.capacity
    _assert_same_layout(t, j)
    _assert_search_match(t, j, _queries(rng, x))


def test_stale_compact_rejected():
    x = np.random.default_rng(5).standard_normal((1000, 16)).astype(np.float32)
    idx = TIVF(16, "l2", num_clusters=8, nprobe=8, min_train_size=100, device="cpu")
    idx.defer_retrain = True
    idx.upsert(list(range(1000)), x)
    idx.delete(list(range(200)))
    cap = idx.capture_compact_state()
    shadow = idx.build_compacted(cap)
    idx.upsert([55_555], x[:1])  # concurrent mutation
    assert not idx.install_compacted(cap, shadow)
    assert idx.search(x[500], top_k=1)[0].primary_key == 500
