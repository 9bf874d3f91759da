"""Port parity among exactly equal scores: every route through which a
search reaches its final k hits returns the JAX package's hits in the JAX
package's order, ties included (tostore_tpu_torch/ops/topk.py
`top_k_first`, and K1's merge `_merge_split_lists`).

Equal scores come from duplicated rows (identical stored rows score
identically within either package), from an all-zero query on cosine, or
are written into the scores directly (+-0.0, NaN, +-inf). The same
numpy-seeded inputs go to both packages, the JAX side's Pallas kernels in
interpret mode; on these CPU tensors the port runs the kernels' plain
versions. `torch_parity.assert_topk_equal` decides: the hits' indices
(rows, slots or pks) equal and in the same order, with no tolerance;
scores within `torch_parity.TOL`. Near-ties between the two packages (bf16
summation order) stay out: each compared cut falls between exactly equal
scores or across a clear gap.

Each selection also runs in its fast form (`fast` cases:
`EXACT_SELECT_MAX = 0`): torch.topk's k + 1 best, then the exact selection
of the rows where they are not strictly decreasing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tostore_tpu.ops.topk as jtopk
import tostore_tpu_torch.ops.topk as ttopk
from torch_parity import NEG_INF, TOL, assert_topk_equal, scan_inputs, tie_inputs

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16", "int8"]
METRICS = ["l2", "cosine", "dot"]
LANE = 128
BLK = 2048


@pytest.fixture(params=["exact", "fast"])
def select_form(request, monkeypatch):
    """`top_k_first` over all keys, or its fast form with its fallback."""
    if request.param == "fast":
        monkeypatch.setattr(ttopk, "EXACT_SELECT_MAX", 0)
    return request.param


@pytest.fixture
def fused_small(monkeypatch):
    """`auto` takes the reference's approximate routes at test size: K1 up
    to 32 queries, the lane scan above (both packages)."""
    monkeypatch.setattr(jtopk, "MIN_FUSED_N", 0)
    monkeypatch.setattr(ttopk, "MIN_FUSED_N", 0)


# --------------------------------------------------------------------------
# The helper against jax.lax.top_k
# --------------------------------------------------------------------------


def _lax_top_k(x, k):
    v, i = jax.lax.top_k(jnp.asarray(x), k)
    return np.asarray(v), np.asarray(i)


def _same_bits(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.int32),
                                  np.asarray(b, np.float32).view(np.int32))


def test_signed_zeros_order_as_reference(select_form):
    # lax.top_k([0., -0., 0., -0., 1.]) gives [4, 0, 2, 1, 3]
    x = np.array([[0.0, -0.0, 0.0, -0.0, 1.0]], np.float32)
    v, p = ttopk.top_k_first(torch.from_numpy(x), 5)
    jv, jp = _lax_top_k(x, 5)
    assert jp.tolist() == [[4, 0, 2, 1, 3]]
    assert p.tolist() == jp.tolist()
    _same_bits(v, jv)


@pytest.mark.parametrize("shape,k", [((3, 50), 7), ((2, 4, 300), 10), ((5, 1000), 40),
                                     ((2, 64), 64), ((4, 5000), 100), ((2, 3, 2000), 1)])
def test_helper_matches_lax_top_k(select_form, shape, k):
    # few distinct values, so most of each row ties: +-0.0, +-inf, +-NaN
    rng = np.random.default_rng(sum(shape) + k)
    vals = np.array([2.0, 1.0, 0.5, 0.0, -0.0, -1.0, np.inf, -np.inf, np.nan, -np.nan],
                    np.float32)
    x = vals[rng.integers(0, len(vals), shape)]
    v, p = ttopk.top_k_first(torch.from_numpy(x), k)
    jv, jp = _lax_top_k(x, k)
    np.testing.assert_array_equal(p.numpy(), jp)
    _same_bits(v, jv)


def test_misses_do_not_make_a_search_row_unsure():
    # equal scores at or below the miss floor (masked, deleted, padded
    # rows) leave torch.topk's answer standing; equal hits do not
    s = torch.tensor([[3.0, 2.0, NEG_INF, NEG_INF, NEG_INF, NEG_INF],
                      [3.0, 2.0, 2.0, 1.0, NEG_INF, NEG_INF]])
    _, _, unsure = ttopk._select_fast(s, 3, ttopk.MISS_FLOOR)
    assert unsure.tolist() == [False, True]
    _, _, unsure = ttopk._select_fast(s, 3)
    assert unsure.tolist() == [True, True]


# --------------------------------------------------------------------------
# Duplicated rows at the kernels' layouts
# --------------------------------------------------------------------------

def _dup_scan(seed, b, n_blocks, dtype, metric):
    """Scan inputs (jax args, torch args, alpha) over n_blocks * 2048 rows
    with copies of one row (`torch_parity.tie_inputs`), queries near it."""
    inputs = tie_inputs(seed, b, n_blocks, 128, dtype, metric)
    return scan_inputs(seed, b, None, 128, dtype, metric, inputs=inputs)


def _kernel_lists(cs, ci, per, t_cands):
    """What K1 leaves at a plan of `per` blocks a split, from the plain
    per-block candidates [B, n_blocks * 256]: a split of at most T/2
    blocks keeps its candidates in insertion order (W = 2 * per; the last,
    shorter split pads with NEG_INF / 0), a longer one its sorted per-lane
    top-T. -> [B, splits * W, 128]."""
    b, w = cs.shape[0], 2 * LANE
    n_blocks = cs.shape[1] // w
    out_s, out_i = [], []
    for a in range(0, n_blocks, per):
        s, i = cs[:, a * w:min(n_blocks, a + per) * w], ci[:, a * w:min(n_blocks, a + per) * w]
        if 2 * per <= t_cands:
            pad = (2 * per * LANE) - s.shape[1]
            s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
            i = torch.nn.functional.pad(i, (0, pad))
        else:
            s, i = ttopk._running_top_t(s, i, t_cands)
        out_s.append(s.reshape(b, -1, LANE))
        out_i.append(i.reshape(b, -1, LANE))
    return torch.cat(out_s, 1), torch.cat(out_i, 1)


@pytest.mark.parametrize("dtype,per,k", [("bfloat16", 2, 10), ("int8", 9, 10), ("float32", 9, 5),
                                         ("bfloat16", 2, 20), ("float32", 2, 5)])
def test_k1_split_merge_keeps_reference_order(select_form, dtype, per, k):
    # K1's per-split lists at the card's kind of plan, merged as the wrapper
    # merges them, against the JAX Pallas kernel: ties across lanes order by
    # t then lane, and the lane holding 36 copies keeps only T of them
    jx, tx, alpha = _dup_scan(140 + per + k, 3, 18, dtype, "l2")
    q, c, bias, scale = tx
    _, blk_b, t_cands, _ = ttopk._acc_plan(q, c, k, None)
    qp = ttopk._pad_queries(q, blk_b, c.dtype)
    cs, ci = ttopk._block_cands_plain(qp, c, bias, scale, alpha, BLK)
    out_s, out_i = _kernel_lists(cs, ci, per, t_cands)
    ts, ti = ttopk._merge_split_lists(out_s, out_i, t_cands, k)
    js, ji = jtopk.fused_flat_topk(jx[0], jx[1], jx[2], k=k, alpha=alpha, row_scale=jx[3])
    assert_topk_equal(ts[:3], ti[:3], js, ji, TOL[dtype])
    if k >= 10:  # more tied copies than k: the key decides the set
        assert (np.asarray(js)[:, :k] == np.asarray(js)[:, :1]).all()


def test_split_merge_distinct_scores():
    # no equal scores: the order is the scores' alone
    jx, tx, alpha = _dup_scan(145, 3, 18, "bfloat16", "l2")
    q, c, bias, scale = tx
    _, blk_b, t_cands, _ = ttopk._acc_plan(q, c, 10, None)
    qp = ttopk._pad_queries(-q, blk_b, c.dtype)  # away from the copies
    cs, ci = ttopk._block_cands_plain(qp, c, bias, scale, alpha, BLK)
    out_s, out_i = _kernel_lists(cs, ci, 2, t_cands)
    ts, ti = ttopk._merge_split_lists(out_s, out_i, t_cands, 10)
    js, ji = jtopk.fused_flat_topk(-jx[0], jx[1], jx[2], k=10, alpha=alpha)
    assert_topk_equal(ts[:3], ti[:3], js, ji, TOL["bfloat16"])


@pytest.mark.parametrize("b", [1, 40])
@pytest.mark.parametrize("mode", ["exact", "auto", "fused"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flat_search_routes(fused_small, dtype, metric, mode, b):
    # 9 blocks: K1 (B = 1), K2 (fused, B = 40), the lane scan (auto, B = 40)
    # and the exact scan over 18 tied candidates in one lane, > T
    jx, tx, alpha = _dup_scan(150 + b, b, 9, dtype, metric)
    js, ji = jtopk.flat_search(jx[0], jx[1], jx[2], k=10, alpha=alpha, mode=mode,
                               row_scale=jx[3])
    ts, ti = ttopk.flat_search(tx[0], tx[1], tx[2], k=10, alpha=alpha, mode=mode,
                               row_scale=tx[3])
    assert_topk_equal(ts, ti, js, ji, TOL[dtype])


def test_exact_chunks_keep_row_order(select_form, monkeypatch):
    # the chunked exact scan (chunks of 4096 rows here) against a numpy
    # oracle: score descending, the lower row first among equal scores
    monkeypatch.setattr(ttopk, "EXACT_CHUNK", 4096)
    _, tx, alpha = _dup_scan(160, 5, 9, "float32", "dot")
    q, c, bias, _ = tx
    n = 4 * 4096
    ts, ti = ttopk.flat_topk_xla(q, c[:n], bias[:n], alpha, 30)
    s = (alpha * (q.double() @ c[:n].double().t()) + bias[:n].double()).float().numpy()
    want = np.stack([np.lexsort((np.arange(n), -row))[:30] for row in s])
    np.testing.assert_array_equal(ti.numpy(), want)


@pytest.mark.parametrize("gsz", [2, None])
@pytest.mark.parametrize("dtype", DTYPES)
def test_group_emit_k5(select_form, dtype, gsz):
    jx, tx, alpha = _dup_scan(170, 16, 9, dtype, "l2")
    js, ji = jtopk._fused_group_emit(jx[0], jx[1], jx[2], k=10, alpha=alpha, blk_n=BLK,
                                     gsz=gsz, row_scale=jx[3])
    ts, ti = ttopk._fused_group_emit(tx[0], tx[1], tx[2], k=10, alpha=alpha, blk_n=BLK,
                                     gsz=gsz, row_scale=tx[3])
    assert_topk_equal(ts, ti, js, ji, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_pipe_topk_k6(dtype):
    import importlib.util
    from pathlib import Path

    from jax.experimental.pallas import tpu as pltpu

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    old = {key: getattr(jax.config, key) for key in keys}
    spec = importlib.util.spec_from_file_location(
        "_exp_pipe", Path(__file__).resolve().parent.parent / "experiments" / "_exp_pipe.py")
    exp_pipe = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(exp_pipe)
    finally:  # the experiment sets a persistent compile cache at import
        for key, value in old.items():
            jax.config.update(key, value)
    jx, tx, alpha = _dup_scan(180, 16, 9, dtype, "l2")
    with pltpu.force_tpu_interpret_mode():
        js, ji = exp_pipe.pipe_topk(jx[0], jx[1], jx[2], k=10, alpha=alpha, gsz=3)
    ts, ti = ttopk.pipe_topk(tx[0], tx[1], tx[2], k=10, alpha=alpha, gsz=3)
    assert_topk_equal(ts, ti, js, ji, TOL[dtype])


# --------------------------------------------------------------------------
# The flat index (ROADMAP queue 3, input 2)
# --------------------------------------------------------------------------


def _motivation_rows():
    """300 rows of 16 dims, rows 20, 35, ..., 290 equal to row 7 (pk 8)."""
    x = np.random.default_rng(3).standard_normal((300, 16)).astype(np.float32)
    x[20:300:15] = x[7]
    return x


def _flat_pair(metric, precision, x, pks=None):
    from tostore_tpu.vector.flat import FlatVectorIndex as JFlat
    from tostore_tpu_torch import FlatVectorIndex as TFlat

    j = JFlat(x.shape[1], metric, precision)
    t = TFlat(x.shape[1], metric, precision, device="cpu")
    pks = list(range(1, len(x) + 1)) if pks is None else pks
    j.upsert(pks, x)
    t.upsert(pks, x)
    return j, t


def _assert_search_equal(j, t, q, k, tol, **kw):
    jd, js, jp = j.search_arrays(q, k, **kw)
    td, ts, tp = t.search_arrays(q, k, **{key: (torch.from_numpy(np.asarray(v))
                                                if key == "slot_mask" else v)
                                          for key, v in kw.items()})
    np.testing.assert_array_equal(ts, np.asarray(js))
    assert tp.tolist() == np.asarray(jp).tolist()
    hit = np.isfinite(np.asarray(jd))
    np.testing.assert_array_equal(np.isfinite(td), hit)
    err = np.abs(td[hit] - np.asarray(jd)[hit]) / np.maximum(1.0, np.abs(np.asarray(jd)[hit]))
    assert not (err > tol).any(), err.max()
    return tp


@pytest.mark.parametrize("b", [1, 40])
@pytest.mark.parametrize("mode", ["exact", "auto", "fused"])
@pytest.mark.parametrize("precision", DTYPES)
@pytest.mark.parametrize("metric", METRICS)
def test_flat_index_duplicate_rows(select_form, fused_small, metric, precision, mode, b):
    x = _motivation_rows()
    j, t = _flat_pair(metric, precision, x)
    q = x[7] + np.float32(0.05)
    if b > 1:
        rng = np.random.default_rng(b)
        q = (q + 0.01 * rng.standard_normal((b, 16))).astype(np.float32)
    pks = _assert_search_equal(j, t, q, 8, TOL[precision], mode=mode)
    if b == 1 and mode == "exact":  # the reproduction's answer
        assert pks.tolist() == [[8, 21, 36, 51, 66, 81, 96, 111]]
    if b == 1 and mode == "fused" and metric == "l2":  # K1's order: t, then lane
        assert pks.tolist() == [[261, 8, 141, 276, 21, 156, 291, 36]]


@pytest.mark.parametrize("mode", ["exact", "auto", "fused"])
@pytest.mark.parametrize("precision", DTYPES)
def test_zero_query_on_cosine(select_form, fused_small, precision, mode):
    # every live row scores 0: the positions alone decide
    x = np.random.default_rng(4).standard_normal((300, 16)).astype(np.float32)
    j, t = _flat_pair("cosine", precision, x)
    for b in (1, 40):
        _assert_search_equal(j, t, np.zeros((b, 16), np.float32), 10, TOL[precision], mode=mode)


@pytest.mark.parametrize("mode", ["exact", "fused"])
def test_ties_straddle_the_kth_place(select_form, mode):
    # 3 rows at distance d1, then 12 tied rows at d2 > d1: k = 8 takes the
    # three and 5 of the twelve, chosen by the key
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((300, 16)) * 3).astype(np.float32)
    q = rng.standard_normal(16).astype(np.float32)
    u = rng.standard_normal((2, 16)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    x[[100, 5, 200]] = q + 0.1 * u[0]
    twelve = [3, 130, 260, 9, 140, 41, 290, 11, 77, 150, 171, 222]
    x[twelve] = q + 0.2 * u[1]
    j, t = _flat_pair("l2", "float32", x)
    pks = _assert_search_equal(j, t, q, 8, TOL["float32"], mode=mode)
    assert set(pks[0][:3]) == {101, 6, 201} and set(pks[0][3:]) < {p + 1 for p in twelve}


@pytest.mark.parametrize("b", [1, 40])
@pytest.mark.parametrize("mode", ["exact", "auto", "fused"])
def test_hybrid_slot_mask(select_form, fused_small, mode, b):
    # a slot mask hides some of the copies: the next ones by key come in
    x = _motivation_rows()
    j, t = _flat_pair("l2", "bfloat16", x)
    mask = np.ones(j.corpus.capacity, bool)
    mask[[7, 35, 95, 140, 215]] = False
    q = np.repeat((x[7] + np.float32(0.05))[None], b, 0)
    _assert_search_equal(j, t, q, 8, TOL["bfloat16"], mode=mode, slot_mask=mask)


@pytest.mark.parametrize("b", [1, 40])
@pytest.mark.parametrize("mode", ["exact", "auto", "fused"])
def test_filter_passes_fewer_than_k(select_form, fused_small, mode, b):
    # 5 live rows, 3 of them copies, under k = 8: the misses (NEG_INF,
    # all equal) fill the rest and come back as slot -1
    x = _motivation_rows()
    j, t = _flat_pair("l2", "bfloat16", x)
    mask = np.zeros(j.corpus.capacity, bool)
    mask[[3, 20, 7, 200, 35]] = True
    q = np.repeat((x[7] + np.float32(0.05))[None], b, 0)
    pks = _assert_search_equal(j, t, q, 8, TOL["bfloat16"], mode=mode, slot_mask=mask)
    assert pks[0][:3].tolist() == [8, 21, 36]


# --------------------------------------------------------------------------
# IVF, raw and PQ (ROADMAP queue 3, input 3)
# --------------------------------------------------------------------------


def _ivf_pair(pq, **kw):
    from tostore_tpu.vector import IVFVectorIndex as JIVF
    from tostore_tpu_torch import convert

    x = np.random.default_rng(5).standard_normal((600, 16)).astype(np.float32)
    x[20:600:25] = x[7]
    args = dict(num_clusters=4, nprobe=4, min_train_size=100, **kw)
    if pq:
        args.update(pq_subspaces=4, pq_rerank=4096)
    j = JIVF(16, "l2", "float32", **args)
    j.upsert(list(range(600)), x)
    t = convert.ivf_index_from_reference(j.state_dict(), "cpu")
    return j, t, x


def _assert_l2_close(got, want, q, tol=TOL["float32"]):
    """l2 distances through their squares, which carry the scores' error:
    within tol * max(1, |q|^2)."""
    lim = tol * np.maximum(1.0, np.sum(q * q, axis=1))[:, None]
    assert (np.abs(np.square(got) - np.square(np.asarray(want))) <= lim).all()


@pytest.mark.parametrize("route", ["contiguous", "gather"])
@pytest.mark.parametrize("mode", ["auto", "probe"])
@pytest.mark.parametrize("pq", [False, True], ids=["raw", "pq"])
def test_ivf_duplicate_rows(pq, mode, route):
    j, t, x = _ivf_pair(pq)
    assert j.trained and t.trained
    if route == "gather":
        for idx in (j, t):
            if pq:
                idx.bucket_codes = None
            else:
                idx.CONTIG_MAX_BYTES = 0
                idx._refresh_bucket_vectors()
    q = np.stack([x[7] + np.float32(0.05), x[7] - np.float32(0.02)])
    jd, js, _ = j.search_arrays(q, 8, mode=mode)
    td, ts, _ = t.search_arrays(q, 8, mode=mode)
    np.testing.assert_array_equal(ts, np.asarray(js))
    _assert_l2_close(td, jd, q)
    if route == "contiguous" and mode == "probe":
        assert ts[0].tolist() == [7, 20, 45, 70, 95, 120, 145, 170]


def test_ivf_untrained_flat_fallback():
    from tostore_tpu.vector import IVFVectorIndex as JIVF
    from tostore_tpu_torch import IVFVectorIndex as TIVF

    x = np.random.default_rng(5).standard_normal((600, 16)).astype(np.float32)
    x[20:600:25] = x[7]
    q = (x[7] + np.float32(0.05))[None]
    ju = JIVF(16, "l2", "float32", num_clusters=4, nprobe=4, min_train_size=10**6)
    tu = TIVF(16, "l2", "float32", num_clusters=4, nprobe=4, min_train_size=10**6,
              device="cpu")
    for idx in (ju, tu):
        idx.upsert(list(range(600)), x)
    assert not ju.trained and not tu.trained
    _, js, _ = ju.search_arrays(q, 8)
    _, ts, _ = tu.search_arrays(q, 8)
    np.testing.assert_array_equal(ts, np.asarray(js))
    assert ts[0].tolist() == [7, 20, 45, 70, 95, 120, 145, 170]


# --------------------------------------------------------------------------
# Sharded (CPU cells against the conftest's virtual devices) and the engine
# --------------------------------------------------------------------------

MESHES = [(1, 4), (2, 2)]


def _meshes(shape):
    from tostore_tpu.parallel import make_mesh as j_make_mesh
    from tostore_tpu_torch.parallel import make_mesh

    dp, nsh = shape
    return (j_make_mesh(dp * nsh, dp=dp),
            make_mesh(dp * nsh, dp=dp, devices=["cpu"] * (dp * nsh)))


@pytest.mark.parametrize("mode", ["exact", "fused"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_flat(select_form, shape, mode):
    # copies in every stripe: each cell's local order, then the merge shard
    # by shard
    from tostore_tpu.parallel import ShardedFlatIndex as JIndex
    from tostore_tpu_torch.parallel import ShardedFlatIndex as TIndex

    jm, tm = _meshes(shape)
    x = np.random.default_rng(9).standard_normal((2000, 48)).astype(np.float32)
    x[20:2000:45] = x[7]
    j, t = JIndex(48, jm, metric="l2"), TIndex(48, tm, metric="l2")
    for idx in (j, t):
        idx.upsert(list(range(2000)), x)
    q = np.stack([x[7] + np.float32(0.05), x[7] - np.float32(0.05)] * 2)
    jd, jp = j.search_arrays(q, 12, mode=mode)
    td, tp = t.search_arrays(q, 12, mode=mode)
    assert tp.tolist() == np.asarray(jp).tolist()
    _assert_l2_close(td, jd, q)


@pytest.mark.parametrize("pq", [0, 8], ids=["raw", "pq"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_ivf(shape, pq):
    # both sides restore one snapshot: the same slots, centroids and books
    from tostore_tpu.parallel.sharded_ivf import ShardedIVFIndex as JIVF
    from tostore_tpu_torch import convert

    jm, tm = _meshes(shape)
    rng = np.random.default_rng(6)
    centers = rng.standard_normal((20, 32)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 20, 3000)] + rng.standard_normal((3000, 32)) * 0.5)
    x = x.astype(np.float32)
    x[20:3000:61] = x[7]
    src = JIVF(32, jm, metric="l2", num_clusters=8, nprobe=4, min_train_size=100,
               pq_subspaces=pq)
    src.upsert(list(range(3000)), x)
    state = src.state_dict()
    j = JIVF.from_state_dict(state, jm)
    t = convert.sharded_ivf_index_from_reference(state, tm)
    q = np.stack([x[7] + np.float32(0.05), x[7] - np.float32(0.05)] * 2)
    jd, jp = j.search_arrays(q, 12)
    td, tp = t.search_arrays(q, 12)
    assert tp.tolist() == np.asarray(jp).tolist()
    _assert_l2_close(td, jd, q)


def test_engine_vector_search():
    # ROADMAP queue 3, input 1: the reference answers [8, 21, 36, ..., 111]
    import tostore_tpu
    import tostore_tpu_torch

    x = _motivation_rows()
    out = []
    for p, kw in ((tostore_tpu, {}), (tostore_tpu_torch, {"device": "cpu"})):
        schema = p.TableSchema(
            name="v",
            fields=(p.FieldSchema("emb", p.DataType.vector,
                                  vector_config=p.VectorFieldConfig(dimensions=16)),),
            indexes=(p.IndexSchema(fields=("emb",), type="vector",
                                   vector_config=p.VectorIndexConfig(metric="l2")),),
        )
        db = p.ToStoreTPU.memory(schemas=[schema], **kw)
        db.batch_insert("v", [{"emb": row.tolist()} for row in x])
        hits = db.vector_search("v", "emb", x[7] + np.float32(0.05), top_k=8)
        filt = db.vector_search("v", "emb", x[7] + np.float32(0.05), top_k=8,
                                condition=p.QueryCondition().where("id", ">", 30))
        out.append(([h.primary_key for h in hits], [h.primary_key for h in filt]))
        db.close()
    assert out[0][0] == [8, 21, 36, 51, 66, 81, 96, 111]
    assert out[1] == out[0]
