"""Port parity for the slice as a whole: tostore_tpu_torch.FlatVectorIndex
against tostore_tpu.vector.FlatVectorIndex.

Both indexes see the same upserts, deletes, overwrites and compact(), made
from a numpy seed; or one is built from the other's state through
tostore_tpu_torch.convert, in both directions. Then search_arrays and
search must agree: capacities and slots exactly, distances within the
tolerances of tests/torch_parity.py (l2 compared before the sqrt), slot
sets outside near-ties. The port runs on the CPU here, so its fused mode
runs the kernels' plain versions; the JAX fused mode runs Pallas in
interpret mode.
"""

import unittest.mock as mock

import numpy as np
import pytest
import torch

from tostore_tpu.vector import FlatVectorIndex as JFlat
from tostore_tpu_torch import FlatVectorIndex as TFlat
from tostore_tpu_torch import VectorSearchResult, convert
from torch_parity import TOL, assert_topk_match

torch.set_num_threads(1)

DIMS = [128, 96]  # 96 pads to 128


def _ops(rng, dims, n=3000):
    """A mutation history: bulk load, deletes, overwrites + inserts that
    reuse freed slots, a second contiguous batch."""
    x = rng.standard_normal((n, dims)).astype(np.float32)
    dead = rng.choice(n, 120, replace=False).tolist()
    over = rng.choice(np.setdiff1d(np.arange(n), dead), 40, replace=False).tolist()
    fresh = list(range(10_000, 10_050))
    tail = list(range(20_000, 21_500))
    return [
        ("upsert", list(range(n)), x),
        ("delete", dead),
        ("upsert", over + fresh,
         rng.standard_normal((len(over) + len(fresh), dims)).astype(np.float32)),
        ("upsert", tail, rng.standard_normal((len(tail), dims)).astype(np.float32)),
        ("delete", tail[::7]),
    ]


def _apply(idx, ops):
    for op in ops:
        if op[0] == "upsert":
            idx.upsert(op[1], op[2])
        else:
            idx.delete(op[1])


def _queries(rng, dims, b=5):
    return rng.standard_normal((b, dims)).astype(np.float32)


def _assert_search_match(t_idx, j_idx, q, k, dtype, mode="auto"):
    td, ts, tp = t_idx.search_arrays(q, k, mode=mode)
    jd, js, jp = j_idx.search_arrays(q, k, mode=mode)
    assert td.dtype == np.float32 and ts.dtype == np.int64 and tp.dtype == object
    assert td.shape == jd.shape == (len(q), k)
    metric = t_idx.metric
    # compare as scores (higher is better): l2 before the sqrt
    qsq = np.sum(q * q, axis=1, dtype=np.float32)[:, None]

    def as_score(dist):
        if metric == "l2":
            return np.where(np.isfinite(dist), qsq - dist.astype(np.float64) ** 2, -np.inf)
        return np.where(np.isfinite(dist), -dist.astype(np.float64), -np.inf)

    neg = float(np.finfo(np.float32).min)
    tsc = np.nan_to_num(as_score(td), neginf=neg)
    jsc = np.nan_to_num(as_score(jd), neginf=neg)
    assert_topk_match(tsc, ts, jsc, js, TOL[dtype])
    assert np.array_equal(ts < 0, js < 0)
    # pks follow slots
    for b in range(len(q)):
        for s, pk in zip(ts[b], tp[b]):
            assert (pk is None) == (s < 0)
            if s >= 0:
                assert t_idx.corpus._slot_pks[s] == pk


@pytest.mark.parametrize("precision", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_same_history_same_results(metric, precision):
    dims = DIMS[(len(metric) + len(precision)) % 2]
    rng = np.random.default_rng(len(metric) * 10 + len(precision))
    ops = _ops(rng, dims)
    t_idx = TFlat(dims, metric, precision, device="cpu")
    j_idx = JFlat(dims, metric, precision)
    _apply(t_idx, ops)
    _apply(j_idx, ops)
    assert t_idx.corpus.capacity == j_idx.corpus.capacity
    assert len(t_idx) == len(j_idx)
    np.testing.assert_array_equal(t_idx.corpus._slot_pks, j_idx.corpus._slot_pks)
    q = _queries(rng, dims)
    _assert_search_match(t_idx, j_idx, q, 10, precision)
    t_idx.compact()
    j_idx.compact()
    assert t_idx.corpus.capacity == j_idx.corpus.capacity
    np.testing.assert_array_equal(t_idx.corpus._slot_pks, j_idx.corpus._slot_pks)
    _assert_search_match(t_idx, j_idx, q, 10, precision)
    # stored vectors read back alike
    pks = [0, 5, 10_003, 20_001]
    pks = [p for p in pks if p in t_idx.corpus._pk_slot]
    np.testing.assert_allclose(t_idx.corpus.get_vectors(pks),
                               j_idx.corpus.get_vectors(pks), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("precision,metric,dims", [
    ("float32", "l2", 128), ("bfloat16", "dot", 96), ("int8", "cosine", 128),
])
def test_fused_mode_matches(precision, metric, dims):
    # capacity 8192 rows (4 blocks): B <= 32 runs K1's plain version, B > 32
    # K2's, against the Pallas kernels in interpret mode
    rng = np.random.default_rng(7)
    ops = _ops(rng, dims, n=6000)
    t_idx = TFlat(dims, metric, precision, device="cpu")
    j_idx = JFlat(dims, metric, precision)
    _apply(t_idx, ops)
    _apply(j_idx, ops)
    assert t_idx.corpus.capacity % 2048 == 0
    _assert_search_match(t_idx, j_idx, _queries(rng, dims, 3), 5, precision, mode="fused")
    _assert_search_match(t_idx, j_idx, _queries(rng, dims, 40), 5, precision, mode="fused")


@pytest.mark.parametrize("precision", ["float32", "bfloat16", "int8"])
def test_state_from_reference(precision):
    rng = np.random.default_rng(11)
    dims = 96
    j_idx = JFlat(dims, "l2", precision)
    _apply(j_idx, _ops(rng, dims))
    j_idx.corpus.filter_columns.update(
        "price", np.arange(5), [1.5, None, 3.0, 4.0, 5.0], j_idx.corpus.capacity)
    j_idx.corpus.filter_columns.update(
        "ts", np.arange(3), [2**40 + 7, -(2**35), None], j_idx.corpus.capacity, kind="int")
    state = j_idx.state_dict()  # compacts
    t_idx = convert.flat_index_from_reference(state, "cpu")
    assert t_idx.corpus.capacity == j_idx.corpus.capacity
    _assert_search_match(t_idx, j_idx, _queries(rng, dims), 10, precision)
    back = t_idx.state_dict()
    assert back["corpus"]["pks"] == state["corpus"]["pks"]
    np.testing.assert_array_equal(
        np.asarray(back["corpus"]["vectors"], np.float32),
        np.asarray(state["corpus"]["vectors"], np.float32))
    fc, jfc = back["corpus"]["filter_columns"], state["corpus"]["filter_columns"]
    np.testing.assert_array_equal(fc["float"]["price"], jfc["float"]["price"])
    for a, b in zip(fc["int"]["ts"], jfc["int"]["ts"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("precision", ["float32", "bfloat16", "int8"])
def test_state_to_reference(precision):
    rng = np.random.default_rng(12)
    dims = 128
    t_idx = TFlat(dims, "cosine", precision, device="cpu")
    _apply(t_idx, _ops(rng, dims))
    t_idx.corpus.filter_columns.update(
        "ts", np.arange(4), [1, None, -5, 2**62], t_idx.corpus.capacity, kind="int")
    state = t_idx.state_dict()
    j_idx = JFlat.from_state_dict(state)
    assert j_idx.corpus.capacity == t_idx.corpus.capacity
    _assert_search_match(t_idx, j_idx, _queries(rng, dims), 10, precision)
    hi, lo, nu = j_idx.corpus.filter_columns.state_dict(upto=4)["int"]["ts"]
    vals = (hi.astype(np.int64) << 32) | lo.astype(np.int64)
    assert vals[0] == 1 and vals[2] == -5 and vals[3] == 2**62
    assert nu.tolist() == [False, True, False, False]
    again = TFlat.from_state_dict(j_idx.state_dict(), device="cpu")
    _assert_search_match(again, j_idx, _queries(rng, dims), 10, precision)


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_single_query_search(metric):
    rng = np.random.default_rng(13)
    dims = 96
    t_idx = TFlat(dims, metric, "float32", device="cpu")
    j_idx = JFlat(dims, metric, "float32")
    ops = _ops(rng, dims)
    _apply(t_idx, ops)
    _apply(j_idx, ops)
    q = rng.standard_normal(dims).astype(np.float32)
    tr = t_idx.search(q, top_k=8)
    jr = j_idx.search(q, top_k=8)
    assert all(isinstance(r, VectorSearchResult) for r in tr)
    assert [r.primary_key for r in tr] == [r.primary_key for r in jr]
    np.testing.assert_allclose([r.distance for r in tr], [r.distance for r in jr],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([r.score for r in tr], [r.score for r in jr],
                               rtol=1e-5, atol=1e-6)
    thr = (tr[2].distance + tr[3].distance) / 2
    assert [r.primary_key for r in t_idx.search(q, top_k=8, threshold=thr)] == \
        [r.primary_key for r in j_idx.search(q, top_k=8, threshold=thr)]


def test_empty_and_all_deleted():
    t_idx = TFlat(64, "dot", device="cpu")
    d, s, p = t_idx.search_arrays(np.ones((2, 64), np.float32), 3)
    assert np.all(np.isinf(d)) and np.all(s == -1) and np.all(p == None)  # noqa: E711
    t_idx.upsert([1, 2], np.ones((2, 64), np.float32))
    t_idx.delete([1, 2])
    d, s, p = t_idx.search_arrays(np.ones(64, np.float32), 3)
    assert np.all(np.isinf(d)) and np.all(s == -1)
    assert t_idx.search(np.ones(64, np.float32)) == []
    with pytest.raises(ValueError):
        TFlat(64, "hamming", device="cpu")
    t_idx.upsert([3], np.ones((1, 64), np.float32))
    with pytest.raises(ValueError):
        t_idx.search_arrays(np.ones((1, 32), np.float32), 3)


def test_contiguous_freelist_refill_keeps_live_rows():
    # 100 slots freed in reverse order are refilled as one contiguous
    # batch of >= 64: only those slots change. Rows after the batch stay
    # live and searchable.
    rng = np.random.default_rng(14)
    x = rng.standard_normal((200, 128)).astype(np.float32)
    t_idx = TFlat(128, "dot", device="cpu")
    t_idx.upsert(list(range(200)), x)
    t_idx.delete(list(range(99, -1, -1)))
    slots = t_idx.upsert(list(range(1000, 1100)),
                         rng.standard_normal((100, 128)).astype(np.float32))
    assert slots.tolist() == list(range(100))
    assert bool(t_idx.corpus.valid[:200].all())
    np.testing.assert_allclose(t_idx.corpus.sq_norms[100:200].numpy(),
                               np.einsum("ij,ij->i", x[100:], x[100:]), rtol=1e-5)
    _, _, pks = t_idx.search_arrays(x[110:111], 1)
    assert pks[0, 0] == 110


def test_maybe_compact_rule():
    t_idx = TFlat(64, "l2", device="cpu")
    t_idx.upsert(list(range(100)), np.ones((100, 64), np.float32))
    t_idx.delete(list(range(5)))
    assert not t_idx.maybe_compact()
    t_idx.delete(list(range(5, 12)))
    assert t_idx.maybe_compact()
    assert t_idx.corpus.deleted_count == 0 and len(t_idx) == 88


# --------------------------------------------------------------------------
# The results stage: slots -> pks and hits -> result objects, held to the
# JAX package's loops on the same arrays
# --------------------------------------------------------------------------


def _slot_table(cap=40):
    """A slot table of int and str pks, tombstones (None) and never-used
    slots, with the capacity it belongs to."""
    table = np.empty(cap, dtype=object)
    table[:30] = [j if j % 3 else f"pk{j}" for j in range(30)]
    table[[4, 17]] = None  # tombstoned
    return table, cap


def _hit_row(case, metric):
    """(dist f32, slots i64, threshold, top_k) for one query's results."""
    cap = _slot_table()[1]
    base = np.float32(-0.5) if metric == "dot" else np.float32(0.0)
    dist = (base + np.arange(14, dtype=np.float32) * np.float32(0.0625)
            + np.float32(1e-3)).astype(np.float32)
    dist[1] = np.float32(-0.0)
    dist[5], dist[8], dist[11] = np.nan, np.inf, -np.inf
    slots = np.array([0, 3, -1, 5, cap, 6, 9, 4, 12, cap + 3, 13, 14, 2, -1], np.int64)
    threshold, top_k = None, 14
    if case == "threshold_mid":
        threshold = float((dist[6] + dist[7]) / 2)
    elif case == "threshold_equal":
        threshold = float(dist[9])
    elif case == "threshold_not_f32":
        threshold = float(dist[9]) - 1e-12  # below dist[9] in f64, equal in f32
    elif case == "no_hit":
        dist = np.full(10, np.inf, np.float32)
        slots = np.full(10, -1, np.int64)
        top_k = 10
    elif case == "short":
        dist, slots = dist[:3].copy(), slots[:3].copy()
    return dist, slots, threshold, top_k


def _same_hits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, VectorSearchResult)
        assert g.primary_key is w.primary_key
        assert g.record is None and w.record is None
    as_bits = lambda rs, f: np.array([getattr(r, f) for r in rs], np.float64).view(np.uint64)  # noqa: E731
    np.testing.assert_array_equal(as_bits(got, "distance"), as_bits(want, "distance"))
    np.testing.assert_array_equal(as_bits(got, "score"), as_bits(want, "score"))


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
@pytest.mark.parametrize("case", ["mixed", "threshold_mid", "threshold_equal",
                                  "threshold_not_f32", "no_hit", "short"])
def test_results_stage_matches_reference_loop(metric, case):
    """`FlatVectorIndex.search`'s results stage against the JAX package's
    loop (its `search` over `pks_for_slots`) on the same arrays: the same
    hits in the same order, pks the same objects, distances bit for bit.
    Scores are bit for bit with the JAX loop's own score map on cosine and
    l2; on dot, torch's sigmoid and XLA's logistic differ by a few ulp on
    some inputs, so the dot scores are held bit for bit to the JAX loop
    running the port's score map, and to the JAX map within 1e-6."""
    from tostore_tpu.ops import distance as JD
    from tostore_tpu_torch.ops import distance as TD

    table, cap = _slot_table()
    dist, slots, threshold, top_k = _hit_row(case, metric)
    t_idx, j_idx = TFlat(8, metric, device="cpu"), JFlat(8, metric)
    for c in (t_idx.corpus, j_idx.corpus):
        c._slot_pks, c.capacity = table.copy(), cap
    q = np.ones(8, np.float32)
    with mock.patch.object(t_idx, "_scan", return_value=(dist[None], slots[None])):
        got = t_idx.search(q, top_k, threshold)
    with mock.patch.object(j_idx, "search_arrays", return_value=(
            dist[None], slots[None], j_idx.corpus.pks_for_slots(slots[None]))):
        want = j_idx.search(q, top_k, threshold)
        with mock.patch.object(JD, "distances_to_scores", lambda m, d: TD.distances_to_scores(
                m, torch.from_numpy(np.array(d))).numpy()):
            want_port_map = j_idx.search(q, top_k, threshold)
    _same_hits(got, want_port_map)
    if metric == "dot":
        _same_hits(got, [VectorSearchResult(w.primary_key, w.distance, g.score)
                         for g, w in zip(got, want)])
        np.testing.assert_allclose([r.score for r in got], [r.score for r in want],
                                   rtol=1e-6, atol=0)
    else:
        _same_hits(got, want)
    # the comparison with the threshold is made in float32, as numpy >= 2
    # compares a float32 with a Python float
    # (on dot, the -0.0 at place 1 lies above the cut mid-row)
    n_kept = {"mixed": 9, "threshold_mid": 4 if metric == "dot" else 5, "threshold_equal": 7,
              "threshold_not_f32": 7, "no_hit": 0, "short": 2}[case]
    assert len(got) == n_kept


@pytest.mark.parametrize("b", [1, 8, 256])
def test_pks_for_slots_matches_reference(b):
    """[B, k] slots, in and out of range, over a slot table with int and
    str pks and tombstones (pk None), against the JAX package's
    `pks_for_slots` on the same table after the same mutations."""
    from tostore_tpu.vector.corpus import DeviceCorpus as JCorpus
    from tostore_tpu_torch.vector.corpus import DeviceCorpus as TCorpus

    rng = np.random.default_rng(b)
    dims, n = 8, 300
    pks = [j if j % 4 else f"s{j}" for j in range(n)]
    x = rng.standard_normal((n, dims)).astype(np.float32)
    t_c, j_c = TCorpus(dims, device="cpu"), JCorpus(dims)
    dead = [pks[j] for j in rng.choice(n, 40, replace=False)]
    for c in (t_c, j_c):
        c.upsert(pks, x)
        assert c.delete(dead) == 40
    assert t_c.capacity == j_c.capacity and t_c.capacity > n
    slots = rng.integers(-3, t_c.capacity + 5, (b, 16))
    live = next(pk for pk in pks[1:] if pk not in dead)
    slots[0, :4] = [-1, t_c.capacity, t_c.capacity - 1, t_c._pk_slot[live]]
    got, want = t_c.pks_for_slots(slots), j_c.pks_for_slots(slots)
    assert got.shape == want.shape == (b, 16) and got.dtype == object
    for g, w in zip(got.reshape(-1).tolist(), want.reshape(-1).tolist()):
        assert g is w
    assert got[0, 3] is live and got[0, 0] is None and got[0, 1] is None
    assert any(t_c._slot_pks[s] is None for s in slots[(slots >= 0) & (slots < n)])


# ----------------------------------------------------------------------------
# one query preparation for the flat scan and the IVF probe
# ----------------------------------------------------------------------------


def _prepared_by(index, q, monkeypatch, module):
    """What `index.search_arrays(q)` hands its scan: the prepared queries
    and their squared norms, caught where `module` calls the helper."""
    real, got = module.prep_queries, []

    def caught(*a):
        got.append(real(*a))
        return got[-1]

    monkeypatch.setattr(module, "prep_queries", caught)
    index.search_arrays(q, 5, **({"mode": "probe"} if index.index_type == "ivf" else {}))
    (out,) = got
    return out


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_flat_and_ivf_prepare_queries_alike(metric, single, monkeypatch):
    from tostore_tpu_torch import IVFVectorIndex
    from tostore_tpu_torch.vector import flat as F
    from tostore_tpu_torch.vector import ivf as V

    rng = np.random.default_rng(17)
    x = rng.standard_normal((600, 40)).astype(np.float32) * 3
    q = rng.standard_normal(40).astype(np.float32) if single else \
        rng.standard_normal((5, 40)).astype(np.float32)
    flat = TFlat(40, metric, "bfloat16", device="cpu")
    flat.upsert(list(range(600)), x)
    ivf = IVFVectorIndex(40, metric, "bfloat16", num_clusters=8, nprobe=2, min_train_size=100,
                         device="cpu")
    ivf.upsert(list(range(600)), x)
    fq, fsq, fsingle = _prepared_by(flat, q, monkeypatch, F)
    iq, isq, isingle = _prepared_by(ivf, q, monkeypatch, V)
    assert torch.equal(fq, iq) and torch.equal(fsq, isq) and fsingle == isingle == single
    # the queries as the flat scan prepared them before the helper
    q2 = np.atleast_2d(q).astype(np.float32)
    want = q2 / np.maximum(np.linalg.norm(q2, axis=1, keepdims=True), 1e-12) \
        if metric == "cosine" else q2
    want = np.pad(want, ((0, 0), (0, flat.corpus.d_pad - 40)))
    np.testing.assert_array_equal(fq.numpy(), want)
    np.testing.assert_array_equal(fsq.numpy(), np.sum(q2 * q2, axis=1))


@pytest.mark.parametrize("shape", [(39,), (2, 41)])
def test_flat_and_ivf_refuse_a_query_of_another_dimension(shape):
    from tostore_tpu_torch import IVFVectorIndex

    x = np.random.default_rng(3).standard_normal((600, 40)).astype(np.float32)
    flat = TFlat(40, "cosine", "bfloat16", device="cpu")
    flat.upsert(list(range(600)), x)
    ivf = IVFVectorIndex(40, "cosine", "bfloat16", num_clusters=8, nprobe=2, min_train_size=100,
                         device="cpu")
    ivf.upsert(list(range(600)), x)
    assert ivf.trained
    q = np.ones(shape, np.float32)
    want = f"query dims {shape[-1]} != index dims 40"
    for call in (lambda: flat.search_arrays(q, 5), lambda: flat.search(q, 5),
                 lambda: ivf.search_arrays(q, 5, mode="probe"), lambda: ivf.search(q, 5)):
        with pytest.raises(ValueError, match=want):
            call()
