"""Port parity for parallel/: `tostore_tpu_torch.parallel` against
`tostore_tpu.parallel`, and the port's own mirror of tests/test_parallel.py.

The same inputs, made from a numpy seed, go to both packages. The JAX side
runs on the conftest's virtual CPU devices (`make_mesh(4)`,
`make_mesh(4, dp=2)`), its Pallas kernels in interpret mode; the port runs
on meshes of 4 CPU cells, (1, 4) and (2, 2), where the kernel wrappers run
their plain versions. Tolerances are stated at each comparison: scores
within tests/torch_parity.py's (1e-5 relative for f32 corpora, 1e-4 for
bf16 and int8, where only the order of summation differs), indices equal
outside near-ties, centroids within 1e-4 absolute (the Lloyd step's sums
add f32 in a different order). Slot numbers, stripe fills and the slice
layout are compared exactly.
"""

import unittest.mock as mock

import numpy as np
import pytest
import torch

from tostore_tpu_torch import convert
from tostore_tpu_torch.ops import distance as TD
from tostore_tpu_torch.parallel import (
    ShardedFlatIndex,
    make_mesh,
    sharded_flat_topk,
    sharded_kmeans,
    sharded_kmeans_step,
)
from tostore_tpu_torch.parallel.mesh import Striped
from tostore_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex
from torch_parity import TOL, assert_topk_match

torch.set_num_threads(1)

MESHES = [(1, 4), (2, 2)]
_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def t_mesh(shape):
    dp, nsh = shape
    return make_mesh(dp * nsh, dp=dp, devices=["cpu"] * (dp * nsh))


def j_mesh(shape):
    from tostore_tpu.parallel import make_mesh as j_make_mesh

    dp, nsh = shape
    return j_make_mesh(dp * nsh, dp=dp)


@pytest.fixture(params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def mesh(request):
    return t_mesh(request.param)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


# --------------------------------------------------------------------------
# The functions against the JAX package's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["auto", "fused"])
def test_sharded_flat_topk_matches_jax(shape, dtype, mode):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tostore_tpu.ops import distance as JD
    from tostore_tpu.parallel import sharded_flat_topk as j_topk
    from tostore_tpu.parallel.mesh import corpus_sharding, query_sharding
    from torch_parity import make_inputs

    n, d, b, k = 4 * 2048, 128, 4, 10
    q, c, scale, valid, alpha = make_inputs(7, b, n, d, dtype, "l2")
    norms = np.sum((c.astype(np.float32) * (scale[:, None] if scale is not None else 1.0)) ** 2,
                   axis=1).astype(np.float32)
    jm = j_mesh(shape)
    sh1 = NamedSharding(jm, P("shard"))
    jc = jax.device_put(jnp.asarray(c).astype({"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                                               "int8": jnp.int8}[dtype]), corpus_sharding(jm))
    jbias = jax.device_put(JD.make_bias("l2", jnp.asarray(norms), jnp.asarray(valid)), sh1)
    jscale = jax.device_put(jnp.asarray(scale), sh1) if scale is not None else None
    js, ji = j_topk(jax.device_put(jnp.asarray(q), query_sharding(jm)), jc, jbias, k=k,
                    alpha=alpha, mesh=jm, mode=mode, row_scale=jscale)

    tm = t_mesh(shape)
    tc = Striped.from_global(tm, torch.from_numpy(c).to(_TORCH_DT[dtype]))
    tbias = Striped.from_global(
        tm, TD.make_bias("l2", torch.from_numpy(norms), torch.from_numpy(valid)))
    tscale = Striped.from_global(tm, scale) if scale is not None else None
    ts, ti = sharded_flat_topk(q, tc, tbias, k=k, alpha=alpha, mesh=tm, mode=mode,
                               row_scale=tscale)
    assert ts.shape == (b, k) and ti.dtype == torch.int64
    # scores within TOL[dtype] (relative), indices equal outside near-ties
    assert_topk_match(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji), TOL[dtype])
    assert not set(ti.numpy().ravel().tolist()) & set(np.flatnonzero(~valid).tolist())


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("scaled", [False, True])
def test_sharded_kmeans_matches_jax(shape, iters, scaled):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tostore_tpu.parallel import sharded_kmeans as j_kmeans

    n, d, c = 4096, 32, 8
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, d)).astype(np.float32)
    valid = rng.random(n) > 0.05
    scales = rng.uniform(0.5, 1.5, n).astype(np.float32) if scaled else None
    cents0 = x[:c].copy()
    jm = j_mesh(shape)
    both = NamedSharding(jm, P(("dp", "shard")))
    jx = jax.device_put(jnp.asarray(x), NamedSharding(jm, P(("dp", "shard"), None)))
    want = np.asarray(j_kmeans(
        jx, jax.device_put(jnp.asarray(cents0), NamedSharding(jm, P())),
        jax.device_put(jnp.asarray(valid), both),
        jax.device_put(jnp.asarray(scales), both) if scaled else None, mesh=jm, iters=iters))
    tm = t_mesh(shape)
    got = sharded_kmeans(
        Striped.from_global(tm, x), cents0, Striped.from_global(tm, valid),
        Striped.from_global(tm, scales) if scaled else None, mesh=tm, iters=iters)
    # the sums add f32 in a different order: atol 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


# --------------------------------------------------------------------------
# ShardedFlatIndex against the reference, step by step
# --------------------------------------------------------------------------


def _assert_results_match(td, tp, jd, jp, metric, q, tol):
    """Distances within tol (compared as scores, l2 before the sqrt); pks
    in the same order, except where the reference's own neighbouring
    scores tie within tol (the order of a near-tie is not fixed) or at the
    cut."""
    assert td.shape == jd.shape and tp.shape == jp.shape
    qsq = np.sum(np.atleast_2d(q) ** 2, axis=1, dtype=np.float32)[:, None]

    def score(dist):
        dist = np.asarray(dist, np.float64)
        s = qsq - dist ** 2 if metric == "l2" else -dist
        return np.where(np.isfinite(dist), s, -1e30)

    ts, js = score(td), score(jd)
    lim = tol * np.maximum(1.0, np.abs(js))
    assert (np.abs(ts - js) <= lim).all(), np.max(np.abs(ts - js) / np.maximum(1, np.abs(js)))
    k = jp.shape[1]
    for b in range(jp.shape[0]):
        for j in range(k):
            if tp[b, j] == jp[b, j]:
                continue
            near = [abs(js[b, j] - js[b, i]) <= 2 * lim[b, j] for i in (j - 1, j + 1)
                    if 0 <= i < k]
            assert j == k - 1 or any(near), (b, j, tp[b], jp[b], js[b])


def _same_corpus_state(t_idx, j_idx):
    assert t_idx.capacity == j_idx.capacity
    assert len(t_idx) == len(j_idx) and t_idx.deleted_count == j_idx.deleted_count
    np.testing.assert_array_equal(t_idx._shard_fill, j_idx._shard_fill)
    np.testing.assert_array_equal(t_idx._slot_pks, j_idx._slot_pks)
    assert list(t_idx._pk_slot.items()) == list(j_idx._pk_slot.items())  # order too
    np.testing.assert_array_equal(t_idx.valid.to_global().numpy(), np.asarray(j_idx.valid))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_sharded_flat_index_matches_reference_step_by_step(shape, dtype, metric):
    from tostore_tpu.parallel import ShardedFlatIndex as JIndex

    dims = 48  # pads to 128
    rng = np.random.default_rng(11)
    t_idx = ShardedFlatIndex(dims, t_mesh(shape), metric=metric, dtype=dtype)
    j_idx = JIndex(dims, j_mesh(shape), metric=metric, dtype=dtype)
    q = rng.standard_normal((5, dims)).astype(np.float32)

    def both(fn):
        return fn(t_idx), fn(j_idx)

    def check(k=10):
        _same_corpus_state(t_idx, j_idx)
        (td, tp), (jd, jp) = both(lambda i: i.search_arrays(q, k))
        # tolerance of tests/torch_parity.py for this storage type
        _assert_results_match(td, tp, jd, jp, t_idx.metric, q, TOL[dtype])
        (td, tp), (jd, jp) = both(lambda i: i.search_arrays(q[0], 3))  # one query, odd under dp
        _assert_results_match(td, tp, jd, jp, t_idx.metric, q[:1], TOL[dtype])
        # search's results stage against the JAX package's loop on the
        # port's own arrays: the same hits, pks the same objects, distances
        # and scores bit for bit
        arrays = t_idx.search_arrays(q[0], k)
        thr = float(np.median(arrays[0][0][np.isfinite(arrays[0][0])]))
        for threshold in (None, thr):
            got = t_idx.search(q[0], k, threshold=threshold)
            with mock.patch.object(j_idx, "search_arrays", return_value=arrays):
                want = j_idx.search(q[0], k, threshold=threshold)
            bits = [np.array([(r.distance, r.score) for r in rs], np.float64).view(np.uint64)
                    for rs in (got, want)]
            np.testing.assert_array_equal(*bits)
            assert all(g.primary_key is w.primary_key for g, w in zip(got, want))
            assert len(got) == (k if threshold is None else (k + 1) // 2)

    x = rng.standard_normal((700, dims)).astype(np.float32)
    ts, js = both(lambda i: i.upsert(list(range(700)), x))
    np.testing.assert_array_equal(ts, js)
    check()
    # overwrite, new pks, and a pk twice in one batch
    pks = [3, 699, 5000, 5001, 5000, 12]
    xo = rng.standard_normal((len(pks), dims)).astype(np.float32)
    xo[4] = xo[2]  # the duplicate carries the same row: which write wins is not fixed
    ts, js = both(lambda i: i.upsert(pks, xo))
    np.testing.assert_array_equal(ts, js)
    check()
    assert both(lambda i: i.delete([5, 321, 5001, 99999])) == (3, 3)
    check()
    # growth across capacity blocks re-stripes
    x2 = rng.standard_normal((9000, dims)).astype(np.float32)
    ts, js = both(lambda i: i.upsert(list(range(10_000, 19_000)), x2))
    np.testing.assert_array_equal(ts, js)
    assert t_idx.capacity > 4 * 2048
    check()
    both(lambda i: i.delete(list(range(10_000, 13_000, 2))))
    assert both(lambda i: round(i.deleted_ratio, 9))[0] == round(j_idx.deleted_ratio, 9)
    assert both(lambda i: i.maybe_compact(0.10)) == (True, True)
    check()
    np.testing.assert_array_equal(t_idx.slots_for_pks([0, 5, 18_999]),
                                  j_idx.slots_for_pks([0, 5, 18_999]))
    # snapshots both ways through convert.py
    t_state, j_state = t_idx.state_dict(), j_idx.state_dict()
    assert t_state["pks"] == j_state["pks"] and set(t_state) == set(j_state)
    assert t_state["vectors"].dtype.name == j_state["vectors"].dtype.name
    np.testing.assert_array_equal(np.asarray(t_state["vectors"], np.float32),
                                  np.asarray(j_state["vectors"], np.float32))
    t_idx = convert.sharded_flat_index_from_reference(j_state, t_mesh(shape))
    j_idx = JIndex.from_state_dict(
        convert.sharded_flat_index_to_reference_state(
            ShardedFlatIndex.from_state_dict(t_state, t_mesh(shape))), j_mesh(shape))
    check()


# --------------------------------------------------------------------------
# ShardedIVFIndex with the reference's centroids and codebooks carried across
# --------------------------------------------------------------------------


def _clustered(rng, nat=30, d=32, n=6000):
    centers = rng.standard_normal((nat, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, nat, n)]
            + rng.standard_normal((n, d)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype,pq", [("float32", (0, 0)), ("bfloat16", (0, 0)), ("int8", (0, 0)),
                                      ("float32", (8, 0)), ("bfloat16", (16, 16))])
def test_sharded_ivf_matches_reference_with_state_carried(shape, dtype, pq):
    from tostore_tpu.parallel.sharded_ivf import ShardedIVFIndex as JIVF

    rng = np.random.default_rng(5)
    x = _clustered(rng)
    n, d = x.shape
    src = JIVF(d, j_mesh(shape), metric="l2", dtype=dtype, num_clusters=16, nprobe=4,
               min_train_size=100, pq_subspaces=pq[0], pq_centroids=pq[1])
    src.upsert(list(range(n)), x)
    src.delete(list(range(0, 300, 3)))
    state = src.state_dict()
    # both sides restore the same snapshot: same slots, same centroids, same books
    j_idx = JIVF.from_state_dict(state, j_mesh(shape))
    t_idx = convert.sharded_ivf_index_from_reference(state, t_mesh(shape))
    assert t_idx.trained and (t_idx.pq is not None) == bool(pq[0])
    _same_corpus_state(t_idx, j_idx)
    # the slice layout, exactly
    np.testing.assert_array_equal(t_idx._slice_base, j_idx._slice_base)
    np.testing.assert_array_equal(t_idx._slice_count, j_idx._slice_count)
    np.testing.assert_array_equal(t_idx._slice_cluster, j_idx._slice_cluster)
    np.testing.assert_array_equal(t_idx._bucket_counts, j_idx._bucket_counts)
    tb, jb = t_idx.buckets.to_global().numpy(), np.asarray(j_idx.buckets)
    assert tb.shape == jb.shape
    for row in range(jb.shape[0]):  # each slice holds the same rows
        assert set(tb[row][tb[row] >= 0].tolist()) == set(jb[row][jb[row] >= 0].tolist()), row
    np.testing.assert_array_equal(t_idx.slot_slice.to_global().numpy(),
                                  np.asarray(j_idx.slot_slice))
    if pq[0]:
        assert (t_idx.bucket_codes is not None) == (j_idx.bucket_codes is not None)
        assert t_idx._pack_nibbles == j_idx._pack_nibbles
        assert tuple(t_idx.bucket_codes.shape) == tuple(j_idx.bucket_codes.shape)
    else:
        assert t_idx.bucket_vectors is not None and j_idx.bucket_vectors is not None
    q = x[rng.integers(0, n, 6)] + rng.standard_normal((6, d)).astype(np.float32) * 0.05
    every = int(t_idx.centroids_exp.shape[0])
    for nprobe in (every, 4):
        td, tp = t_idx.search_arrays(q, 10, nprobe=nprobe)
        jd, jp = j_idx.search_arrays(q, 10, nprobe=nprobe)
        # scores within the storage type's tolerance, order equal off ties
        _assert_results_match(td, tp, jd, jp, "l2", q, TOL[dtype])
    # and the state goes back: the reference opens the port's snapshot
    back = JIVF.from_state_dict(convert.sharded_ivf_index_to_reference_state(t_idx),
                                j_mesh(shape))
    np.testing.assert_array_equal(back._slice_count, j_idx._slice_count)
    np.testing.assert_array_equal(back._slot_pks, j_idx._slot_pks)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_ivf_gather_routes_match_reference(shape):
    """The two fallback probes (no contiguous copy), held to the
    reference's on the same restored snapshot."""
    from tostore_tpu.parallel.sharded_ivf import ShardedIVFIndex as JIVF

    rng = np.random.default_rng(6)
    x = _clustered(rng, n=4000)
    n, d = x.shape
    q = x[rng.integers(0, n, 4)]
    for pq in (0, 8):
        src = JIVF(d, j_mesh(shape), metric="l2", num_clusters=8, nprobe=4, min_train_size=100,
                   pq_subspaces=pq)
        src.upsert(list(range(n)), x)
        state = src.state_dict()
        j_idx = JIVF.from_state_dict(state, j_mesh(shape))
        t_idx = convert.sharded_ivf_index_from_reference(state, t_mesh(shape))
        for idx in (t_idx, j_idx):
            idx.bucket_vectors = idx.bucket_codes = None
            if not pq:
                idx.bucket_bias = None
        td, tp = t_idx.search_arrays(q, 10)
        jd, jp = j_idx.search_arrays(q, 10)
        _assert_results_match(td, tp, jd, jp, "l2", q, TOL["float32"])


# --------------------------------------------------------------------------
# The port's own mirror of tests/test_parallel.py, on (1, 4) and (2, 2)
# --------------------------------------------------------------------------


class TestShardedTopk:
    def test_parity_with_oracle(self, mesh, rng):
        n, d, b, k = 4096, 64, 4, 10
        x = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((b, d)).astype(np.float32)
        s, i = sharded_flat_topk(q, Striped.from_global(mesh, x),
                                 Striped.from_global(mesh, np.zeros(n, np.float32)),
                                 k=k, mesh=mesh)
        ref = np.argsort(-(q @ x.T), axis=1)[:, :k]
        np.testing.assert_array_equal(i.numpy(), ref)

    def test_tombstones_respected(self, mesh, rng):
        n, d, k = 2048, 64, 5
        x = rng.standard_normal((n, d)).astype(np.float32)
        valid = np.ones(n, bool)
        valid[100] = False
        bias = Striped.from_global(mesh, TD.make_bias("dot", None, torch.from_numpy(valid)))
        _, i = sharded_flat_topk(np.repeat(x[100:101], 2, 0), Striped.from_global(mesh, x), bias,
                                 k=k, mesh=mesh)
        assert 100 not in i.numpy()


class TestShardedKmeans:
    def test_matches_single_device(self, mesh, rng):
        n, d, c = 4096, 32, 8
        x = rng.standard_normal((n, d)).astype(np.float32)
        cents0 = x[:c].copy()
        new = sharded_kmeans_step(Striped.from_global(mesh, x), cents0,
                                  Striped.from_global(mesh, np.ones(n, bool)), mesh=mesh).numpy()
        d2 = ((x[:, None, :] - cents0[None]) ** 2).sum(-1)
        assign = d2.argmin(1)
        ref = np.stack(
            [x[assign == j].mean(0) if (assign == j).any() else cents0[j] for j in range(c)]
        )
        np.testing.assert_allclose(new, ref, rtol=1e-4, atol=1e-4)


class TestShardedIndex:
    def test_search_and_mutation(self, mesh, rng):
        idx = ShardedFlatIndex(48, mesh, metric="l2")
        x = rng.standard_normal((700, 48)).astype(np.float32)
        idx.upsert(list(range(700)), x)
        assert len(idx) == 700
        d, pks = idx.search_arrays(x[321], k=3)
        assert pks[0][0] == 321 and d[0][0] == pytest.approx(0.0, abs=1e-2)
        idx.delete([321])
        _, pks = idx.search_arrays(x[321], k=1)
        assert pks[0][0] != 321
        # growth across capacity blocks keeps data intact
        x2 = rng.standard_normal((3000, 48)).astype(np.float32)
        idx.upsert(list(range(1000, 4000)), x2)
        _, pks = idx.search_arrays(x2[7], k=1)
        assert pks[0][0] == 1007

    def test_batch_queries_parity(self, mesh, rng):
        idx = ShardedFlatIndex(32, mesh, metric="cosine")
        x = rng.standard_normal((512, 32)).astype(np.float32)
        idx.upsert(list(range(512)), x)
        q = rng.standard_normal((6, 32)).astype(np.float32)
        _, pks = idx.search_arrays(q, k=5)
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        ref = np.argsort(-(qn @ xn.T), axis=1)[:, :5]
        for row, rref in zip(pks, ref):
            assert len(set(row) & set(rref.tolist())) >= 4


def _recall(idx, x, q, k, nprobe):
    d2 = np.sum((q[:, None, :] - x[None]) ** 2, axis=-1)
    ex = np.argsort(d2, axis=1)[:, :k]
    hits = 0
    for bi in range(len(q)):
        got = {r.primary_key for r in idx.search(q[bi], top_k=k, nprobe=nprobe)}
        hits += len(got & set(ex[bi].tolist()))
    return hits / (len(q) * k)


class TestShardedIVFSlices:
    def test_skewed_clusters_recall(self, mesh, rng):
        # hard clustered data with more natural modes than centroids: the
        # sliced layout must keep every row in its true nearest cluster
        x = _clustered(rng, nat=40, n=8000)
        n, d = x.shape
        idx = ShardedIVFIndex(d, mesh, metric="l2", num_clusters=16, nprobe=6,
                              min_train_size=100)
        idx.upsert(list(range(n)), x)
        assert idx.trained
        assert idx.centroids_exp.shape[0] > 16  # fat natural clusters forced slicing
        q = x[rng.integers(0, n, 8)] + rng.standard_normal((8, d)).astype(np.float32) * 0.05
        assert _recall(idx, x, q, 10, 6) >= 0.9

    def test_sharded_residual_pq_recall_and_persistence(self, mesh, rng):
        nat, d, n = 40, 32, 8000
        centers = rng.standard_normal((nat, d)).astype(np.float32) * 4
        x = (centers[rng.integers(0, nat, n)]
             + rng.standard_normal((n, d)) * 0.5).astype(np.float32)
        idx = ShardedIVFIndex(d, mesh, metric="l2", num_clusters=16, nprobe=6,
                              min_train_size=100, pq_subspaces=8)
        idx.upsert(list(range(n)), x)
        assert idx.trained and idx.pq is not None and idx.codes is not None
        q = x[rng.integers(0, n, 8)] + rng.standard_normal((8, d)).astype(np.float32) * 0.05
        assert _recall(idx, x, q, 10, 6) >= 0.85
        # incremental append keeps codes fresh
        xq = centers[7] + rng.standard_normal(d).astype(np.float32) * 0.1
        idx.upsert([90_000], xq[None].astype(np.float32))
        assert idx.search(xq, top_k=1, nprobe=6)[0].primary_key == 90_000
        # persistence round-trip keeps residual-PQ search working
        idx2 = ShardedIVFIndex.from_state_dict(idx.state_dict(), mesh)
        assert idx2.pq is not None
        assert idx2.search(xq, top_k=1, nprobe=6)[0].primary_key == 90_000

    def test_incremental_append_lands_in_slices(self, mesh, rng):
        d, n = 16, 2000
        x = rng.standard_normal((n, d)).astype(np.float32)
        idx = ShardedIVFIndex(d, mesh, metric="l2", num_clusters=8, nprobe=8,
                              min_train_size=500)
        idx.upsert(list(range(n)), x)
        assert idx.trained
        # post-training incremental upserts go through _append_to_buckets
        x2 = rng.standard_normal((64, d)).astype(np.float32)
        idx.upsert(list(range(10_000, 10_064)), x2)
        assert idx.search(x2[17], top_k=1, nprobe=8)[0].primary_key == 10_017


class TestEntrypoints:
    def test_entry_runs(self):
        import __graft_entry_torch__ as g

        fn, args = g.entry(device="cpu")
        s, i = fn(*args)
        assert s.shape == (8, 10) and i.shape == (8, 10)

    def test_entry_defaults_to_the_card(self):
        import __graft_entry_torch__ as g

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default builds on it")
        with pytest.raises((RuntimeError, AssertionError)):
            g.entry()

    @pytest.mark.parametrize("n", [8, 4, 1])
    def test_dryrun_multichip(self, n):
        import __graft_entry_torch__ as g

        g.dryrun_multichip(n, device="cpu")

    def test_dryrun_multichip_defaults_to_the_card(self):
        import __graft_entry_torch__ as g

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default runs on it")
        with pytest.raises((RuntimeError, AssertionError)):
            g.dryrun_multichip(4)


class TestShardedInt8:
    def test_flat_int8_matches_f32(self, mesh, rng):
        n, d, k = 4000, 64, 10
        x = rng.standard_normal((n, d)).astype(np.float32) * 3  # outside [-1,1]
        i8 = ShardedFlatIndex(d, mesh, metric="l2", dtype="int8")
        i8.upsert(list(range(n)), x)
        f32 = ShardedFlatIndex(d, mesh, metric="l2", dtype="float32")
        f32.upsert(list(range(n)), x)
        q = x[rng.integers(0, n, 6)] + rng.standard_normal((6, d)).astype(np.float32) * 0.05
        d8, p8 = i8.search_arrays(q, k)
        df, pf = f32.search_arrays(q, k)
        agree = np.mean([
            len({p for p in p8[i] if p is not None} & set(pf[i])) / k
            for i in range(6)
        ])
        assert agree >= 0.9
        assert np.max(np.abs(d8[:, 0] - df[:, 0])) < 0.5  # quant tolerance
        # persistence dequantizes + re-quantizes cleanly
        i8b = ShardedFlatIndex.from_state_dict(i8.state_dict(), mesh)
        assert i8b.precision == "int8"
        _, p8b = i8b.search_arrays(q, k)
        assert {p for p in p8b[0] if p is not None} == {p for p in p8[0] if p is not None}

    def test_sharded_ivf_int8(self, mesh, rng):
        x = _clustered(rng)
        n, d = x.shape
        idx = ShardedIVFIndex(d, mesh, metric="l2", dtype="int8",
                              num_clusters=16, nprobe=6, min_train_size=100)
        idx.upsert(list(range(n)), x)
        assert idx.trained and idx.scales is not None
        assert _recall(idx, x, x[rng.integers(0, n, 6)], 10, 6) >= 0.8

    def test_sharded_ivf_int8_pq(self, mesh, rng):
        d, n = 32, 4000
        x = rng.standard_normal((n, d)).astype(np.float32)
        idx = ShardedIVFIndex(d, mesh, metric="l2", dtype="int8",
                              num_clusters=8, nprobe=8, min_train_size=100,
                              pq_subspaces=8)
        idx.upsert(list(range(n)), x)
        assert idx.pq is not None
        assert idx.search(x[42], top_k=1, nprobe=8)[0].primary_key == 42

    def test_int8_compact_preserves_scales(self, mesh, rng):
        # compact must not re-quantize raw int8 codes as if they were true
        # values (every per-vector scale would reset to ~1.0)
        n, d = 2000, 32
        x = rng.standard_normal((n, d)).astype(np.float32) * 3
        idx = ShardedFlatIndex(d, mesh, metric="l2", dtype="int8")
        idx.upsert(list(range(n)), x)
        idx.delete(list(range(500)))
        d0, p0 = idx.search_arrays(x[1000], k=1)
        assert p0[0][0] == 1000 and d0[0][0] < 3.0
        scales0 = idx.scales.gather(idx.slots_for_pks([1000, 1500])).numpy()
        idx.compact()
        d1, p1 = idx.search_arrays(x[1000], k=1)
        assert p1[0][0] == 1000 and d1[0][0] < 3.0
        np.testing.assert_allclose(
            idx.scales.gather(idx.slots_for_pks([1000, 1500])).numpy(), scales0, rtol=1e-6)

    def test_bf16_state_is_two_bytes_a_value(self, mesh, rng):
        x = rng.standard_normal((300, 32)).astype(np.float32)
        idx = ShardedFlatIndex(32, mesh, metric="dot", dtype="bfloat16")
        idx.upsert(list(range(300)), x)
        state = idx.state_dict()
        assert state["vectors"].dtype.name == "bfloat16" and state["vectors"].nbytes == 300 * 128 * 2
        again = ShardedFlatIndex.from_state_dict(state, mesh)
        np.testing.assert_array_equal(again.vectors.to_global().view(torch.int16).numpy(),
                                      idx.vectors.to_global().view(torch.int16).numpy())


class TestFilterColumnsFollowRows:
    def test_growth_restripe_moves_the_filter_columns(self, mesh, rng):
        """Growth re-stripes the rows to new slots; the slot-aligned
        predicate columns must move with them. (The JAX package leaves
        them at the old slots, `tostore_tpu/parallel/sharded.py:199-223`:
        after this history 2,250 of 12,000 rows read another row's value
        there. The port is held to the rows' own values.)"""
        idx = ShardedFlatIndex(16, mesh, "l2")
        x = rng.standard_normal((12_000, 16)).astype(np.float32)
        s1 = idx.upsert(list(range(3000)), x[:3000])
        idx.filter_columns.update("n", s1, list(range(3000)), idx.capacity, kind="int")
        idx.filter_columns.update("f", s1, [i / 2 for i in range(3000)], idx.capacity)
        cap = idx.capacity
        s2 = idx.upsert(list(range(3000, 12_000)), x[3000:])
        assert idx.capacity > cap
        idx.filter_columns.update("n", s2, list(range(3000, 12_000)), idx.capacity, kind="int")
        got = idx.filter_columns.gather_host(idx.slots_for_pks(list(range(12_000))))
        hi, lo, nul = got["int"]["n"]
        assert not nul.any()
        np.testing.assert_array_equal((hi.astype(np.int64) << 32) | lo, np.arange(12_000))
        np.testing.assert_array_equal(got["float"]["f"][:3000], np.arange(3000) / 2)
        assert np.isnan(got["float"]["f"][3000:]).all()


class TestShardedContigProbes:
    """The mesh probe path must run the bucket-contiguous scans
    (ops/ivfprobe.py: K3 / K4 on a CUDA cell), not the row-gather fallback."""

    def test_raw_contig_active_and_matches_gather(self, mesh, rng):
        x = _clustered(rng)
        n, d = x.shape
        idx = ShardedIVFIndex(d, mesh, metric="l2", num_clusters=16,
                              nprobe=6, min_train_size=100)
        idx.upsert(list(range(n)), x)
        assert idx.trained
        assert idx.bucket_vectors is not None  # contig stripes built
        assert idx.bucket_bias is not None
        q = x[rng.integers(0, n, 6)]
        with mock.patch("tostore_tpu_torch.vector.ivf.bucket_probe_scores",
                        side_effect=__import__("tostore_tpu_torch").ops.ivfprobe
                        .bucket_probe_scores) as k3:
            d_c, p_c = idx.search_arrays(q, k=10)
        assert k3.call_count == len(mesh.owned)  # once per owned cell
        # force the gather fallback and compare
        bv, bb = idx.bucket_vectors, idx.bucket_bias
        idx.bucket_vectors = None
        idx.bucket_bias = None
        try:
            d_g, p_g = idx.search_arrays(q, k=10)
        finally:
            idx.bucket_vectors, idx.bucket_bias = bv, bb
        for i in range(6):
            assert set(p_c[i]) == set(p_g[i])
        # the contig path folds norms computed FROM the stored rows; the
        # gather path uses the f32 norms: rounding-level differences
        np.testing.assert_allclose(np.sort(d_c, 1), np.sort(d_g, 1),
                                   rtol=1e-3, atol=5e-2)

    def test_pq_contig_active_and_matches_gather(self, mesh, rng):
        x = _clustered(rng)
        n, d = x.shape
        idx = ShardedIVFIndex(d, mesh, metric="l2", num_clusters=16,
                              nprobe=6, min_train_size=100, pq_subspaces=8)
        idx.upsert(list(range(n)), x)
        assert idx.pq is not None
        assert idx.bucket_codes is not None  # contig ADC stripes built
        q = x[rng.integers(0, n, 6)]
        with mock.patch("tostore_tpu_torch.vector.ivf.adc_bucket_scores",
                        side_effect=__import__("tostore_tpu_torch").ops.ivfprobe
                        .adc_bucket_scores) as k4:
            d_c, p_c = idx.search_arrays(q, k=10)
        assert k4.call_count == len(mesh.owned)
        bc = idx.bucket_codes
        idx.bucket_codes = None
        try:
            d_g, p_g = idx.search_arrays(q, k=10)
        finally:
            idx.bucket_codes = bc
        for i in range(6):
            # same re-rank pool ordering: exact sets match
            assert set(p_c[i]) == set(p_g[i])

    def test_nibble_packed_mesh_codes(self, mesh, rng):
        # K=16, M=16 -> nibble-packed [C, M/2, cap] contiguous codes
        x = _clustered(rng, d=32)
        n, d = x.shape
        idx = ShardedIVFIndex(d, mesh, metric="l2", num_clusters=16,
                              nprobe=6, min_train_size=100,
                              pq_subspaces=16, pq_centroids=16)
        idx.upsert(list(range(n)), x)
        assert idx.pq is not None and idx._pack_nibbles
        assert idx.bucket_codes is not None
        assert idx.bucket_codes.shape[1] == 8  # M/2 packed rows
        # incremental append re-packs fresh codes into the contiguous
        # stripes (the [rows, :, cols] scatter shape is easy to break)
        xq = x[3] + rng.standard_normal(d).astype(np.float32) * 0.01
        idx.upsert([70_000], xq[None])
        assert idx.search(xq, top_k=1, nprobe=6)[0].primary_key == 70_000
        assert _recall(idx, x, x[rng.integers(0, n, 6)], 10, 6) >= 0.8

    def test_delete_invalidates_contig_bias(self, mesh, rng):
        x = _clustered(rng)
        n, d = x.shape
        idx = ShardedIVFIndex(d, mesh, metric="l2", num_clusters=16,
                              nprobe=8, min_train_size=100)
        idx.upsert(list(range(n)), x)
        assert idx.bucket_vectors is not None
        r = idx.search(x[123], top_k=1, nprobe=8)
        assert r[0].primary_key == 123
        idx.delete([123])
        assert idx._bias_stale
        r2 = idx.search(x[123], top_k=3, nprobe=8)
        assert all(h.primary_key != 123 for h in r2)
        assert not idx._bias_stale  # search re-cached the refreshed bias

    def test_slot_mask_on_contig_path(self, mesh, rng):
        x = _clustered(rng)
        n, d = x.shape
        idx = ShardedIVFIndex(d, mesh, metric="l2", num_clusters=16,
                              nprobe=8, min_train_size=100)
        idx.upsert(list(range(n)), x)
        target = 77
        slot = int(idx.slots_for_pks([target])[0])
        mask = np.ones(idx.capacity, bool)
        mask[slot] = False
        d_m, p_m = idx.search_arrays(x[target], k=3, slot_mask=torch.from_numpy(mask))
        assert target not in set(p_m[0])
        # the cached (unmasked) bias must be untouched
        d_u, p_u = idx.search_arrays(x[target], k=1)
        assert p_u[0][0] == target

    def test_exact_mode_bypasses_the_probe(self, mesh, rng):
        x = _clustered(rng)
        n, d = x.shape
        idx = ShardedIVFIndex(d, mesh, metric="l2", num_clusters=16, nprobe=1,
                              min_train_size=100)
        idx.upsert(list(range(n)), x)
        q = x[rng.integers(0, n, 5)]
        _, pks = idx.search_arrays(q, 10, mode="exact")
        ex = np.argsort(np.sum((q[:, None, :] - x[None]) ** 2, axis=-1), axis=1)[:, :10]
        for row, want in zip(pks, ex):
            assert set(row) == set(want.tolist())


class TestShardedBackgroundMaintenance:
    """Capture / build / install on the mesh index: mesh rebuilds run
    off-lock with searches proceeding against the old layout, and a
    concurrent mutation must abort install."""

    def _mk(self, mesh, rng, n=2000, d=16, pq=0):
        x = rng.standard_normal((n, d)).astype(np.float32)
        idx = ShardedIVFIndex(d, mesh, metric="l2", num_clusters=8, nprobe=8,
                              min_train_size=100, pq_subspaces=pq)
        idx.defer_retrain = True
        idx.upsert(list(range(n)), x)
        return idx, x

    def test_deferred_growth_retrain(self, mesh, rng):
        idx, x = self._mk(mesh, rng, n=600)
        t0 = idx._trained_size
        x2 = rng.standard_normal((2000, 16)).astype(np.float32)
        idx.upsert(list(range(10_000, 12_000)), x2)  # 4x growth, no stall
        assert idx._trained_size == t0  # inline retrain skipped
        assert idx.needs_retrain()
        cap = idx.capture_build_state()
        shadow = idx.build_retrained(cap)
        # searches against the OLD layout still work mid-build
        assert idx.search(x[5], top_k=1)[0].primary_key == 5
        assert idx.install_retrained(cap, shadow)
        assert not idx.needs_retrain()
        assert idx.search(x2[7], top_k=1)[0].primary_key == 10_007
        assert idx.bucket_vectors is not None  # contig stripes rebuilt

    def test_stale_retrain_install_rejected(self, mesh, rng):
        idx, x = self._mk(mesh, rng, n=600)
        x2 = rng.standard_normal((2000, 16)).astype(np.float32)
        idx.upsert(list(range(10_000, 12_000)), x2)
        cap = idx.capture_build_state()
        shadow = idx.build_retrained(cap)
        idx.upsert([99_999], x[:1])  # concurrent mutation
        assert not idx.install_retrained(cap, shadow)
        assert idx.search(x[5], top_k=1)[0].primary_key == 5

    def test_background_compact(self, mesh, rng):
        idx, x = self._mk(mesh, rng, n=2000)
        idx.delete(list(range(0, 2000, 3)))
        assert idx.needs_compact(0.10)
        cap = idx.capture_compact_state()
        old_vectors = idx.vectors
        shadow = idx.build_compacted(cap)
        assert idx.search(x[1], top_k=1)[0].primary_key == 1  # mid-build
        assert idx.install_compacted(cap, shadow)
        assert idx.vectors is not old_vectors  # new stripes, the old ones stay whole
        assert idx.deleted_count == 0
        assert len(idx) == 2000 - len(range(0, 2000, 3))
        assert idx.search(x[1], top_k=1)[0].primary_key == 1
        assert all(r.primary_key % 3 != 0
                   for r in idx.search(x[4], top_k=10))

    def test_background_compact_pq_keeps_codebooks(self, mesh, rng):
        idx, x = self._mk(mesh, rng, n=2000, pq=8)
        book = idx.pq
        idx.delete(list(range(0, 2000, 3)))
        cap = idx.capture_compact_state()
        shadow = idx.build_compacted(cap)
        assert idx.install_compacted(cap, shadow)
        assert idx.pq is book  # codebooks transfer, residual space unchanged
        assert idx.codes is not None and idx.bucket_codes is not None
        assert idx.search(x[7], top_k=1)[0].primary_key == 7

    def test_stale_compact_rejected(self, mesh, rng):
        idx, x = self._mk(mesh, rng, n=1200)
        idx.delete(list(range(300)))
        cap = idx.capture_compact_state()
        shadow = idx.build_compacted(cap)
        idx.upsert([55_555], x[:1])
        assert not idx.install_compacted(cap, shadow)
        assert idx.search(x[500], top_k=1)[0].primary_key == 500


class TestShardedIncrementalOverwrite:
    def test_overwrite_moves_cluster_without_rebuild(self, mesh, rng):
        # an upsert of existing pks must vacate + re-append incrementally
        nat, d, n = 10, 32, 4000
        centers = rng.standard_normal((nat, d)).astype(np.float32) * 6
        x = (centers[rng.integers(0, nat, n)]
             + rng.standard_normal((n, d)) * 0.3).astype(np.float32)
        idx = ShardedIVFIndex(d, mesh, metric="l2", num_clusters=8, nprobe=8,
                              min_train_size=100)
        idx.upsert(list(range(n)), x)
        assert idx.trained
        # overwrite pk 7 with a vector near a DIFFERENT natural center
        newv = (centers[3] + rng.standard_normal(d) * 0.1).astype(np.float32)
        with mock.patch.object(
            ShardedIVFIndex, "_rebuild_buckets",
            side_effect=AssertionError("rebuild must not run"),
        ):
            idx.upsert([7], newv[None])
        hit = idx.search(newv, top_k=1, nprobe=8)[0]
        assert hit.primary_key == 7
        # the old location no longer surfaces pk 7 for its old vector
        old_hits = {r.primary_key for r in idx.search(x[7], top_k=5, nprobe=8)}
        if 7 in old_hits:  # only acceptable if new vector genuinely near
            assert float(np.sum((newv - x[7]) ** 2)) < 50

    def test_overwrite_with_pq_codes(self, mesh, rng):
        d, n = 32, 3000
        x = rng.standard_normal((n, d)).astype(np.float32)
        idx = ShardedIVFIndex(d, mesh, metric="l2", num_clusters=8, nprobe=8,
                              min_train_size=100, pq_subspaces=8)
        idx.upsert(list(range(n)), x)
        assert idx.pq is not None and idx.bucket_codes is not None
        newv = rng.standard_normal(d).astype(np.float32)
        with mock.patch.object(
            ShardedIVFIndex, "_rebuild_buckets",
            side_effect=AssertionError("rebuild must not run"),
        ):
            idx.upsert([42], newv[None])
        assert idx.search(newv, top_k=1, nprobe=8)[0].primary_key == 42


class TestMesh:
    def test_shape_and_cells(self):
        m = t_mesh((2, 2))
        assert m.shape == {"dp": 2, "shard": 2} and m.axis_names == ("dp", "shard")
        assert len(m.devices.flat) == 4 and len(m.owned) == 4
        assert all(c.rank == 0 and c.device.type == "cpu" for c in m.devices.flat)
        with pytest.raises(ValueError, match="divisible"):
            make_mesh(4, dp=3, devices=["cpu"] * 4)

    def test_a_mesh_of_cards_never_falls_back_to_the_cpu(self):
        if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
            pytest.skip("four cards are present")
        with pytest.raises(RuntimeError, match="cards"):
            make_mesh(4)

    def test_striped_scatter_gather_by_global_row(self):
        m = t_mesh((2, 2))
        st = Striped.full(m, 8, (3,), 0.0, torch.float32)
        rows = np.array([0, 7, 8, 15, 9])
        vals = np.arange(15, dtype=np.float32).reshape(5, 3)
        st.scatter(rows, vals)
        np.testing.assert_array_equal(st.gather(rows).numpy(), vals)
        np.testing.assert_array_equal(st.gather(rows[::-1].copy()).numpy(), vals[::-1])
        for dpi in range(2):  # both dp copies were written
            np.testing.assert_array_equal(st.part(dpi, 1)[[0, 7, 1]].numpy(), vals[[2, 3, 4]])
        assert st.to_global().shape == (16, 3) and st.shape == (16, 3)
        assert st.gather(np.zeros(0, np.int64)).shape == (0, 3)
