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
