"""Port parity and planning tests that need no card:

  - `IVFVectorIndex.maybe_compact` / `quiescent_s` against
    tostore_tpu.vector.IVFVectorIndex on the same numpy-seeded rows
    (untrained and trained; below and above the 10% rule; searches after a
    compaction equal the reference's; the quiescence clock restarts at every
    upsert and delete);
  - the flat `auto` route (`ops.topk._auto_route`): CPU tensors keep the
    reference's route, a CUDA device sends B > 32 to K2 (an f32 corpus up
    to 256 queries);
  - `_flat_beats_probe`'s decisions for a CUDA device at a few (B, nprobe,
    index kind) points, beside the unchanged CPU ones;
  - the grouped kernels' grid plan (`_group_grid_plan`, `_group_cta`): lane
    halves x query tiles x groups cover every (group, lane, query) once.

Tolerances are those of tests/torch_parity.py.
"""

import time

import numpy as np
import pytest
import torch

import tostore_tpu_torch.ops.topk as ttopk
from tostore_tpu.vector import IVFVectorIndex as JIVF
from tostore_tpu_torch import IVFVectorIndex as TIVF
from torch_parity import TOL, assert_topk_match

torch.set_num_threads(1)


def _rows(seed, n=1200, d=32, nat=20):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nat, d)).astype(np.float32) * 3
    x = (centers[rng.integers(0, nat, n)] + rng.standard_normal((n, d))).astype(np.float32)
    return x, rng


def _both(trained, seed, precision="float32"):
    x, rng = _rows(seed)
    kw = dict(num_clusters=8, nprobe=8, min_train_size=100 if trained else 10**9)
    j = JIVF(32, "l2", precision, **kw)
    t = TIVF(32, "l2", precision, device="cpu", **kw)
    for idx in (j, t):
        idx.upsert(list(range(len(x))), x)
        assert idx.trained == trained
    return j, t, x, rng


def _scores(d, q):
    return np.sum(q * q, axis=1)[:, None] - np.asarray(d, np.float64) ** 2


# ----------------------------------------------------------------------------
# A1: maybe_compact / quiescent_s
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("trained", [False, True])
@pytest.mark.parametrize("n_deleted,threshold,want", [
    (0, 0.10, False),     # nothing deleted
    (60, 0.10, False),    # 5%: below the rule
    (120, 0.10, True),    # exactly 10%
    (300, 0.10, True),
    (300, 0.50, False),   # a caller's higher threshold
    (60, 0.01, True),
])
def test_maybe_compact_matches_reference(trained, n_deleted, threshold, want):
    j, t, x, _ = _both(trained, 3)
    for idx in (j, t):
        idx.delete(list(range(0, 2 * n_deleted, 2)))
    assert t.corpus.deleted_count == j.corpus.deleted_count == n_deleted
    muts = t._mutations
    assert t.maybe_compact(threshold) is want
    assert j.maybe_compact(threshold) is want
    assert t.corpus.deleted_count == j.corpus.deleted_count == (0 if want else n_deleted)
    assert t.corpus.capacity == j.corpus.capacity and len(t) == len(j)
    assert (t._mutations > muts) is want  # a compaction is a mutation: RCU builds go stale


@pytest.mark.parametrize("trained", [False, True])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_search_after_maybe_compact_matches_reference(trained, precision):
    j, t, x, rng = _both(trained, 11, precision)
    gone = list(range(100, 400))
    for idx in (j, t):
        idx.delete(gone)
        assert idx.maybe_compact() is True  # the default threshold, 10%
    np.testing.assert_array_equal(t.corpus._slot_pks, j.corpus._slot_pks)
    q = x[rng.integers(0, len(x), 6)] + rng.standard_normal((6, 32)).astype(np.float32) * 0.1
    for mode in ("auto", "exact") + (("probe",) if trained else ()):
        td, ts, tp = t.search_arrays(q, 10, mode=mode)
        jd, js, _ = j.search_arrays(q, 10, mode=mode)
        assert_topk_match(_scores(td, q), ts, _scores(jd, q), js, TOL[precision])
        assert not set(tp.ravel()) & set(gone)
    assert t.search(x[50], top_k=1)[0].primary_key == 50
    assert t.maybe_compact() is False  # nothing left to compact


def test_maybe_compact_rebuilds_trained_layout():
    _, t, x, _ = _both(True, 5)
    t.delete(list(range(0, 600)))
    assert t.maybe_compact() is True
    placed = t.buckets_slots[t.buckets_slots >= 0]
    assert placed.numel() == len(t) == 600
    assert int(placed.max()) < t.corpus.capacity
    assert bool(t.corpus.valid[placed].all())


@pytest.mark.parametrize("trained", [False, True])
def test_quiescent_s_restarts_at_every_mutation(trained):
    j, t, x, _ = _both(trained, 7)
    for idx in (j, t):
        for mutate in (lambda: idx.upsert([5000], x[:1] + 0.5),
                       lambda: idx.delete([5000]),
                       lambda: idx.upsert([3], x[4:5]),  # an overwrite
                       lambda: idx.compact()):
            time.sleep(0.03)
            assert idx.quiescent_s() >= 0.03
            before = time.monotonic()
            mutate()
            assert idx._last_mut_t >= before
            assert idx.quiescent_s() <= time.monotonic() - before
    fresh = TIVF(8, "l2", device="cpu")
    assert fresh._last_mut_t == JIVF(8, "l2")._last_mut_t == 0.0
    assert fresh.quiescent_s() > 0.0  # never mutated: quiet since the clock's origin


# ----------------------------------------------------------------------------
# A2: the flat auto route
# ----------------------------------------------------------------------------

DTYPES = [torch.float32, torch.bfloat16, torch.int8]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b_pad,cpu,cuda", [
    (8, "fused", "fused"), (32, "fused", "fused"),
    (40, "lane", "fused"), (64, "lane", "fused"), (128, "lane", "fused"),
    (256, "lane", "fused"), (264, "lane", None), (512, "lane", None),
])
def test_auto_route(dtype, b_pad, cpu, cuda):
    if cuda is None:  # past 256 queries the f32 FMA K2 has lost to the lane scan
        cuda = "lane" if dtype == torch.float32 else "fused"
    assert ttopk._auto_route(b_pad, dtype, "cpu") == cpu
    assert ttopk._auto_route(b_pad, dtype, "cuda") == cuda


@pytest.mark.parametrize("b", [8, 33, 40, 256])
def test_auto_route_is_what_flat_search_takes(monkeypatch, b):
    """flat_search asks `_auto_route` with the padded batch, the corpus's
    dtype and its device type, and follows it."""
    asked, calls = [], []
    real = ttopk._auto_route
    monkeypatch.setattr(ttopk, "_auto_route",
                        lambda *a: asked.append(a) or real(*a))
    for name in ("flat_topk_lane", "fused_flat_topk"):
        fn = getattr(ttopk, name)
        monkeypatch.setattr(ttopk, name,
                            lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw))
    monkeypatch.setattr(ttopk, "MIN_FUSED_N", 4096)
    c = torch.randn(4096, 128).to(torch.bfloat16)
    ttopk.flat_search(torch.randn(b, 128), c, torch.zeros(4096), k=5)
    assert asked == [(-(-b // 8) * 8, torch.bfloat16, "cpu")]
    assert calls == ["fused_flat_topk" if b <= 32 else "flat_topk_lane"]
    # a route that says "fused" is followed for any batch
    calls.clear()
    monkeypatch.setattr(ttopk, "_auto_route", lambda *a: "fused")
    ttopk.flat_search(torch.randn(b, 128), c, torch.zeros(4096), k=5)
    assert calls == ["fused_flat_topk"]


# ----------------------------------------------------------------------------
# A3: the IVF auto route's cost model
# ----------------------------------------------------------------------------

GB_1M = 1_048_576 * 768 * 2   # 1M x 768 bf16, the raw index the CUDA constants were fitted on
GB_500K = 524_288 * 768 * 2   # the PQ indexes' corpus


@pytest.mark.parametrize("nbytes,kind,b,nprobe,flat_wins", [
    # the decisions every measured run on the card agrees on (nprobe 16):
    # raw 1M rows from B = 128: the probe
    (GB_1M, "raw", 128, 16, False), (GB_1M, "raw", 256, 16, False),
    # PQ 500k rows: the flat scan at every batch
    (GB_500K, "adc4", 1, 16, True), (GB_500K, "adc4", 8, 16, True),
    (GB_500K, "adc4", 64, 16, True), (GB_500K, "adc4", 256, 16, True),
    (GB_500K, "adc8", 1, 16, True), (GB_500K, "adc8", 8, 16, True),
    (GB_500K, "adc8", 64, 16, True), (GB_500K, "adc8", 256, 16, True),
])
def test_cuda_route_costs(nbytes, kind, b, nprobe, flat_wins):
    flat_ms, probe_ms = TIVF._route_costs(nbytes, b, nprobe, kind, "cuda")
    assert (flat_ms < probe_ms) is flat_wins, (flat_ms, probe_ms)


@pytest.mark.parametrize("b", [1, 8, 32, 64])
def test_cuda_route_costs_raw_small_batch_is_within_spread(b):
    """Raw 1M rows up to B = 64: the measured routes changed order between
    runs, so no decision is pinned; the model's two costs must lie within
    the host clock's 40% spread of each other, as the measured ones did."""
    flat_ms, probe_ms = TIVF._route_costs(GB_1M, b, 16, "raw", "cuda")
    assert max(flat_ms, probe_ms) <= 1.4 * min(flat_ms, probe_ms), (flat_ms, probe_ms)


@pytest.mark.parametrize("kind", ["raw", "adc4", "adc8"])
def test_cuda_route_cost_model_shape(kind):
    """What the model's form says beyond the measured points: the flat cost
    grows with the corpus and not with nprobe, the probe's with B x nprobe
    and not with the corpus."""
    flat, probe = TIVF._route_costs(GB_1M, 64, 16, kind, "cuda")
    flat_big, probe_big = TIVF._route_costs(8 * GB_1M, 64, 16, kind, "cuda")
    flat_np, probe_np = TIVF._route_costs(GB_1M, 64, 64, kind, "cuda")
    assert flat_big > flat and probe_big == probe
    assert flat_np == flat and probe_np > probe


@pytest.mark.parametrize("kind,step", [("raw", 2.2), ("adc4", 5.4), ("adc8", 18.0)])
@pytest.mark.parametrize("b,nprobe", [(1, 4), (32, 16), (256, 64)])
def test_cpu_route_costs_are_the_references(kind, step, b, nprobe):
    """On CPU tensors the model is the JAX package's, constant for constant
    (test_torch_ivf.py::test_flat_beats_probe_decisions_match holds the
    decisions equal on live indexes)."""
    flat_ms, probe_ms = TIVF._route_costs(GB_1M, b, nprobe, kind, "cpu")
    assert flat_ms == GB_1M / (JIVF.FLAT_GBPS * 1e6) + JIVF.FLAT_PER_QUERY_US * b / 1e3
    assert probe_ms == JIVF.PROBE_BASE_MS + step * b * nprobe / 1e3
    for name in ("PROBE_BASE_MS", "PROBE_STEP_US", "PROBE_STEP_ADC4_US", "PROBE_STEP_ADC8_US",
                 "FLAT_GBPS", "FLAT_PER_QUERY_US", "FALLBACK_MIN_BYTES"):
        assert getattr(TIVF, name) == getattr(JIVF, name)


# ----------------------------------------------------------------------------
# Part B: the grouped kernels' grid plan
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("b_pad,n_groups,want", [
    (256, 16, (64, 4)),   # 128 CTAs of 64 queries fill 132 SMs
    (128, 16, (32, 4)),   # 64 CTAs would not: 128 of 32 queries
    (40, 16, (32, 2)),
    (8, 1, (32, 1)),
    (256, 64, (64, 4)),
    (72, 64, (64, 2)),    # many groups: the wide tile fills the card at any batch
])
def test_group_grid_plan(b_pad, n_groups, want):
    assert ttopk._group_grid_plan(b_pad, n_groups, 132) == want


@pytest.mark.parametrize("b_pad", [8, 40, 72, 104, 128, 256])
@pytest.mark.parametrize("n_blocks,gsz", [(64, 4), (13, 5), (6, 6), (7, 1)])
@pytest.mark.parametrize("sms", [132, 16])
def test_group_grid_covers_every_pair_once(b_pad, n_blocks, gsz, sms):
    """Every (group, lane, query) is served by exactly one CTA; a partial
    last group and a batch that is no multiple of the query tile
    included."""
    n_groups = -(-n_blocks // gsz)
    tile_b, q_tiles = ttopk._group_grid_plan(b_pad, n_groups, sms)
    assert tile_b in ttopk.GROUP_TILE_B and q_tiles * tile_b >= b_pad > (q_tiles - 1) * tile_b
    seen = np.zeros((n_groups, 128, q_tiles * tile_b), np.int32)
    last = None
    for x in range(n_groups * 2 * q_tiles):
        g, half, qt = ttopk._group_cta(x, q_tiles)
        assert 0 <= g < n_groups and half in (0, 1) and 0 <= qt < q_tiles
        blocks = range(g * gsz, min(n_blocks, (g + 1) * gsz))
        assert len(blocks) >= 1
        seen[g, 64 * half : 64 * half + 64, qt * tile_b : (qt + 1) * tile_b] += 1
        assert last is None or (g, half, qt) > last  # a group's CTAs are adjacent
        last = (g, half, qt)
    assert (seen == 1).all()


def test_group_wrappers_pad_to_whole_tiles_and_check_inputs():
    c = torch.zeros(4096, 128, dtype=torch.bfloat16)
    bias = torch.zeros(4096)
    q = torch.zeros(8, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ttopk._lane_topk_group_cuda(q, c, bias, None, 1.0, 2048, 0)
    with pytest.raises(ValueError):
        ttopk._lane_topk_group_pipe_cuda(q, c, bias, 1.0, 2048, 3)
    with pytest.raises(TypeError):
        ttopk._lane_topk_group_cuda(q.float(), c, bias, None, 1.0, 2048, 1)
    assert set(ttopk.LAUNCHES) >= {"lane_topk_group", "lane_topk_group_pipe",
                                   "lane_topk_group_f32", "lane_topk_group_pipe_f32"}
