"""The flat scan's K1 route over the live prefix, as one CUDA graph
(`FlatVectorIndex._dispatch` and `ScanState` in vector/flat.py,
`DeviceCorpus.scan` in vector/corpus.py, ops/graphs.py).

On the CPU: which searches take K1's route (decided on the whole capacity,
also where the live prefix is shorter than MIN_FUSED_N) and which of them
may run as graphs (on a CUDA device); a search over the live
prefix equal to a K1 scan of the whole capacity bit for bit, in distances,
slots and order, for every metric and field precision, with tied scores,
freed slots reused below the high-water mark, k past the live rows and a
slot mask; the key's tensor identities (stable under in-place writes and
appends within a K1 block, new when the high-water mark crosses into
the next, on growth and on compaction); the old corpus freed wherever the corpus
replaces its tensors; the counters moving only once a search's stage ran,
masked searches included; and no graph counter moving on the CPU.

On the card (marker `cuda`): replayed answers equal the eager search's and
a K1 scan of the whole capacity bit for bit at B = 1, 4 and 32, masked
and unmasked, for every metric and field precision, also where K1's
splits of several blocks cut prefix and capacity apart; the same after each
mutation, with a capture wherever the key changed; exact, B = 64 and
short-table searches run eagerly; a search that finds its key held by
another thread runs eagerly; per-search launch counts equal on both
paths. This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flat_graph.py
"""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch

import tostore_tpu_torch.ops.topk as ttopk
import tostore_tpu_torch.vector.flat as flat_mod
from tostore_tpu_torch import FlatVectorIndex, IVFVectorIndex
from tostore_tpu_torch.ops import distance as tdist
from tostore_tpu_torch.ops import graphs
from tostore_tpu_torch.ops.runtime import ROW_BLOCK

torch.set_num_threads(1)

GRAPH_KEYS = ("flat_graph", "flat_graph_capture")
METRICS = ["cosine", "l2", "dot"]
PRECISIONS = ["bfloat16", "float32", "int8"]
K = 10
TIE_SRC = 37  # copied down its own lane (more than T = 16 copies) and into other lanes


@pytest.fixture
def small_k1(monkeypatch):
    """Auto's fused route from 4,096 slots: small tables then scan a
    prefix shorter than their capacity on K1."""
    monkeypatch.setattr(ttopk, "MIN_FUSED_N", 4096)


def _index(device, metric="l2", precision="bfloat16", n=5000, d=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    idx = FlatVectorIndex(d, metric, precision, device=device)
    idx.upsert(list(range(n)), x)
    return idx, x, rng


def _prefix(c):
    return flat_mod.scan_state(c).prefix(c)


def _graphs(idx):
    return flat_mod.scan_state(idx.corpus).graphs


def _ident(idx):
    return graphs.identities(_prefix(idx.corpus))


def _graph_counts():
    return {k: ttopk.LAUNCHES[k] for k in GRAPH_KEYS}


def _queries(rng, x, n):
    return x[rng.integers(0, len(x), n)] + 0.1 * rng.standard_normal((n, x.shape[1])).astype(
        np.float32)


def _whole(idx, q, k, mask=None):
    """K1 over the whole capacity, as the search ran before the prefix:
    (distances, slots) on the host."""
    qt, qsq, _ = idx._prep_queries(q)
    bias, alpha, scale = idx._bias_alpha(mask)
    s, i = ttopk.fused_flat_topk(qt, idx.corpus.vectors, bias, k=k, alpha=alpha,
                                 row_scale=scale)
    return flat_mod.to_host(*tdist.finalize_results(idx.metric, s, i, qsq))


def _assert_bits(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))


# --------------------------------------------------------------------------
# CPU: the route and the path decision
# --------------------------------------------------------------------------


@pytest.mark.parametrize("device,b,mode,n,k,want", [
    ("cuda", 1, "auto", 1 << 20, K, True),
    ("cuda", 32, "auto", 1 << 20, K, True),
    ("cuda:1", 4, "fast", 1 << 20, 100, True),
    ("cuda", 1, "fused", 2048, K, True),       # forced K1 on a short table
    ("cuda", 1, "auto", 2048, K, False),       # auto below MIN_FUSED_N: exact
    ("cuda", 1, "exact", 1 << 20, K, False),
    ("cuda", 33, "auto", 1 << 20, K, False),   # K2
    ("cuda", 64, "fused", 1 << 20, K, False),  # K2
    ("cuda", 1, "auto", 1 << 20, 257, False),  # k past two candidates a lane
    ("cpu", 1, "auto", 1 << 20, K, False),     # K1's prefix, eagerly
])
def test_graph_path_decision(device, b, mode, n, k, want):
    """A search runs as graphs where it is on K1's route and on a CUDA
    device (the CPU's K1 reads the prefix eagerly); a slot mask changes
    neither."""
    dev = torch.device(device).type
    on_k1 = ttopk.flat_route(b, (n, 128), torch.bfloat16, dev, k, mode) == "k1"
    assert (on_k1 and dev == "cuda") is want
    assert on_k1 is (want or device == "cpu")


@pytest.mark.parametrize("mode,b,route", [
    ("auto", 1, "k1"), ("auto", 32, "k1"), ("fused", 8, "k1"), ("exact", 1, "exact"),
])
def test_the_route_stays_on_the_capacity(monkeypatch, mode, b, route):
    """A table whose capacity reaches MIN_FUSED_N keeps K1 with a live
    prefix shorter than MIN_FUSED_N, and K1 reads only the prefix; the
    exact route reads the whole capacity."""
    idx, x, rng = _index("cpu", "l2", "bfloat16", n=70_000, d=16)
    c = idx.corpus
    n_scan = _prefix(c)[0].shape[0]
    assert n_scan == 71_680 < ttopk.MIN_FUSED_N <= c.capacity
    seen = []
    for name in ("fused_flat_topk", "flat_topk_xla"):
        real = getattr(ttopk, name)
        monkeypatch.setattr(ttopk, name, lambda q, corpus, *a, _r=real, _n=name, **kw: (
            seen.append((_n, corpus.shape[0])), _r(q, corpus, *a, **kw))[1])
    q = _queries(rng, x, b)
    want = _whole(idx, q, K) if route == "k1" else None
    seen.clear()
    got = idx.search_arrays(q, K, mode=mode)
    assert seen == ([("fused_flat_topk", n_scan)] if route == "k1"
                    else [("flat_topk_xla", c.capacity)])
    if want is not None:
        _assert_bits(got[:2], want)


# --------------------------------------------------------------------------
# CPU: the live prefix gives the whole capacity's answer, bit for bit
# --------------------------------------------------------------------------


def _scenario(idx, x, rng, case):
    """Mutate the table for one case: (queries, k, slot mask or None)."""
    n, d = x.shape
    k = K
    mask = None
    q = _queries(rng, x, 4)
    if case == "ties":
        rows = [TIE_SRC + 128 * j for j in range(n // 128)]
        rows += [blk * ROW_BLOCK + lane for blk in (0, 1) for lane in (0, 5, 64, 100, 127)]
        idx.upsert(rows, np.repeat(x[TIE_SRC][None], len(rows), 0))
        q = x[TIE_SRC][None] + 1e-3 * rng.standard_normal((4, d)).astype(np.float32)
        k = 40
    elif case == "reused":
        idx.delete(list(range(0, n, 5)))
        fresh = q[rng.integers(0, 4, 600)] + 0.05 * rng.standard_normal((600, d)).astype(
            np.float32)
        idx.upsert(list(range(n, n + 600)), fresh)  # into freed slots below the mark
        assert idx.corpus._high == n
    elif case == "k_past_live":
        idx.delete(list(range(150, n)))
        k = 200
    elif case == "masked":
        mask = torch.from_numpy(rng.random(idx.corpus.capacity) < 0.3)
        mask[n:] = True  # bits past the live rows change nothing
    return q, k, mask


@pytest.mark.parametrize("case", ["random", "ties", "reused", "k_past_live", "masked"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("metric", METRICS)
def test_prefix_equals_the_whole_capacity(small_k1, metric, precision, case):
    idx, x, rng = _index("cpu", metric, precision)
    q, k, mask = _scenario(idx, x, rng, case)
    c = idx.corpus
    assert _prefix(c)[0].shape[0] == 6144 < c.capacity == 12_288
    got = idx.search_arrays(q, k, slot_mask=mask)
    want = _whole(idx, q, k, mask)
    _assert_bits(got[:2], want)
    if case == "k_past_live":
        assert (got[1][:, 150:] == -1).all() and (got[1][:, :150] >= 0).all()
    if case == "ties":  # the copies tie, more than T of them in one lane
        assert (got[0][:, :K] == got[0][:, :1]).all()
    if case == "masked":
        assert mask[got[1][got[1] >= 0]].all()


# --------------------------------------------------------------------------
# CPU: the key
# --------------------------------------------------------------------------


def test_key_stable_under_in_place_writes_and_appends_within_the_grain(small_k1):
    """The grain is one K1 block (ROW_BLOCK): 5,000 rows scan 6,144 slots."""
    idx, x, rng = _index("cpu")
    ident = _ident(idx)
    idx.search_arrays(x[:2], K)
    assert _ident(idx) == ident
    idx.upsert(list(range(100)), x[:100] + 0.5)  # overwrites in place
    idx.delete(list(range(200, 400)))
    idx.upsert(list(range(10_000, 10_150)), x[:150])  # into freed slots
    idx.upsert(list(range(20_000, 21_000)), x[:1000])  # 50 freed slots, then 5000 -> 5950
    assert idx.corpus._high == 5950  # within the prefix of 6144
    assert _ident(idx) == ident


@pytest.mark.parametrize("mutation", ["cross_grain", "growth", "compact"])
def test_key_changes_when_the_prefix_moves_or_is_replaced(small_k1, mutation):
    idx, x, rng = _index("cpu")
    c = idx.corpus
    ident, cap = _ident(idx), c.capacity
    if mutation == "cross_grain":
        idx.upsert(list(range(10_000, 11_500)), x[:1500])  # 5000 -> 6500 > 6144
        assert c.capacity == cap
    elif mutation == "growth":
        idx.upsert(list(range(10_000, 18_000)), np.tile(x, (2, 1))[:8000])
        assert c.capacity > cap
    else:
        idx.delete(list(range(0, 5000, 3)))
        idx.compact()
    assert _ident(idx) != ident
    assert _prefix(c)[0].shape[0] == min(c.capacity, -(-c._high // ROW_BLOCK) * ROW_BLOCK)


def _replace(idx, x, how):
    if how == "growth":
        idx.upsert(list(range(10_000, 18_000)), np.tile(x, (2, 1))[:8000])
    elif how == "compact":
        idx.delete(list(range(0, len(x), 3)))
        idx.compact()
    else:  # the IVF index's off-lock compaction installs another corpus's tensors
        idx.delete(list(range(0, len(x), 3)))
        cap = idx.capture_compact_state()
        assert idx.install_compacted(cap, idx.build_compacted(cap))


@pytest.mark.parametrize("how", ["growth", "compact", "install_compacted"])
def test_replacing_the_corpus_frees_the_captured_tensors(small_k1, how):
    """An entry holds the prefix views its graph reads, and the corpus's
    `scan` its prefix views and entries. Where the corpus replaces its
    tensors `scan` is dropped, so the old corpus is freed at once, with no
    search in between."""
    if how == "install_compacted":
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2000, 32)).astype(np.float32)
        idx = IVFVectorIndex(32, "l2", "bfloat16", num_clusters=16, nprobe=4,
                             min_train_size=100, device="cpu")
        idx.upsert(list(range(2000)), x)
    else:
        idx, x, _ = _index("cpu")
    c = idx.corpus
    _graphs(idx).acquire((1, K, False, "auto"), _prefix(c))  # as on the card
    assert len(_graphs(idx)) == 1
    old = weakref.ref(c.vectors)
    _replace(idx, x, how)
    gc.collect()
    assert c.scan is None
    assert old() is None


# --------------------------------------------------------------------------
# CPU: the counters and the entry's release
# --------------------------------------------------------------------------


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("captures", [True, False])
def test_graph_counters_move_once_the_stage_ran(small_k1, monkeypatch, captures, masked):
    """A search counts as replayed (and its key as captured) after its
    stage ran, a masked one too: a capture that fails fails the search and
    counts nothing, and the key's later searches run eagerly. The capture
    search's answer is the eager one. The CPU gives the cache no key: the
    test gives it one, as the card's searches do."""
    idx, x, rng = _index("cpu")
    made, keys = [], []
    real = graphs.GraphCache.stages

    def stages(self, key, held, *inputs):
        keys.append(key)
        return real(self, (len(inputs[0]), len(inputs)), held, *inputs)

    def capture(self, fn):
        if not captures:
            raise RuntimeError("capture failed")
        made.append(_FakeGraph())
        return made[-1], fn(), []

    monkeypatch.setattr(graphs.GraphCache, "stages", stages)
    monkeypatch.setattr(graphs.StageGraphs, "_capture", capture)
    mask = torch.from_numpy(rng.random(idx.corpus.capacity) < 0.5) if masked else None
    q = _queries(rng, x, 6)
    before = _graph_counts()
    idx.search_arrays(q[:2], K, slot_mask=mask)  # the key recorded: eager
    assert _graph_counts() == before
    (key,) = [k for k, _ in _graphs(idx)._entries]
    assert key == (2, 3 if masked else 2)  # a mask is one more static input
    if captures:
        got = idx.search_arrays(q[2:4], K, slot_mask=mask)
        _assert_bits(got[:2], _whole(idx, q[2:4], K, mask))
        idx.search_arrays(q[4:6], K, slot_mask=mask)
        assert _graph_counts() == {"flat_graph": before["flat_graph"] + 2,
                                   "flat_graph_capture": before["flat_graph_capture"] + 1}
        assert len(made) == 1 and made[0].replays == 2
    else:
        with pytest.raises(RuntimeError):
            idx.search_arrays(q[2:4], K, slot_mask=mask)
        got = idx.search_arrays(q[4:6], K, slot_mask=mask)  # the broken key: eager
        _assert_bits(got[:2], _whole(idx, q[4:6], K, mask))
        assert _graph_counts() == before
    # the search skeleton released the entry after each search, a failed one too
    assert not any(e.lock.locked() for e in _graphs(idx)._entries.values())
    assert keys == [None] * 3


def test_no_graph_counter_moves_on_the_cpu(small_k1):
    idx, x, rng = _index("cpu")
    mask = torch.from_numpy(rng.random(idx.corpus.capacity) < 0.5)
    before = _graph_counts()
    for i in range(3):
        idx.search_arrays(x[i: i + 1], K)
        idx.search_arrays(x[i: i + 4], K, slot_mask=mask)
        idx.search(x[i], top_k=K, mode="fused")
    assert _graph_counts() == before
    assert len(_graphs(idx)) == 0  # the cache is never given a key on the CPU


# --------------------------------------------------------------------------
# The card
# --------------------------------------------------------------------------

CARD_N = 40_000  # capacity 81,920, live prefix 40,960 slots


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs of the card's kernels")
    monkeypatch.setattr(ttopk, "MIN_FUSED_N", 4096)  # the card tables take auto's K1
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _card_index(dev, metric="l2", precision="bfloat16"):
    idx, x, rng = _index(dev, metric, precision, n=CARD_N, d=128)
    c = idx.corpus
    assert _prefix(c)[0].shape[0] == 40_960 < c.capacity == 81_920
    return idx, x, rng


def _masks(rng, idx, n):
    return [torch.from_numpy(rng.random(idx.corpus.capacity) < 0.5).to(idx.device)
            for _ in range(n)]


def _search_all(idx, qs, b, masks=None, k=K, **kw):
    d, s = [], []
    for j, i in enumerate(range(0, len(qs), b)):
        mask = masks[j] if masks is not None else None
        dist, slots, _ = idx.search_arrays(qs[i: i + b], k, slot_mask=mask, **kw)
        d.append(dist)
        s.append(slots)
    return np.concatenate(d), np.concatenate(s)


def _eager(monkeypatch, idx, qs, b, masks=None, **kw):
    with monkeypatch.context() as m:
        m.setattr(graphs.GraphCache, "acquire", lambda self, key, held: None)
        return _search_all(idx, qs, b, masks, **kw)


def _whole_all(idx, qs, b, masks=None):
    d, s = [], []
    for j, i in enumerate(range(0, len(qs), b)):
        dist, slots = _whole(idx, qs[i: i + b], K, masks[j] if masks is not None else None)
        d.append(dist)
        s.append(slots)
    return np.concatenate(d), np.concatenate(s)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b", [1, 4, 32])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("metric", METRICS)
def test_replay_equals_eager_bit_for_bit(cuda, monkeypatch, metric, precision, b, masked):
    idx, x, rng = _card_index(cuda, metric, precision)
    qs = _queries(rng, x, 64 if b < 32 else 128)
    n = len(qs) // b
    masks = _masks(rng, idx, n) if masked else None
    want = _eager(monkeypatch, idx, qs, b, masks)
    _assert_bits(want, _whole_all(idx, qs, b, masks))  # the prefix is the whole capacity
    before = _graph_counts()
    got = _search_all(idx, qs, b, masks)
    _assert_bits(got, want)
    # the first search of the key runs eagerly, the second captures
    assert _graph_counts() == {"flat_graph": before["flat_graph"] + n - 1,
                               "flat_graph_capture": before["flat_graph_capture"] + 1}
    assert [k for k, _ in _graphs(idx)._entries] == [(b, K, masked, "auto")]


@pytest.mark.cuda
@pytest.mark.parametrize("per", [5, 9])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_prefix_equals_the_whole_capacity_across_split_plans(cuda, monkeypatch, precision, per):
    """K1's splits of `per` blocks a CTA, as a large table gives (5: each
    block's pair kept unsorted; 9: the sorted per-lane top-T), cut the 20
    blocks of the prefix and the 40 of the capacity at other places: the
    replayed answers equal a K1 scan of the whole capacity bit for bit,
    ties and a mask included."""
    monkeypatch.setattr(ttopk, "_split_plan",
                        lambda n_blocks, b_tiles, sms, ctas_per_sm=1: (per, -(-n_blocks // per)))
    idx, x, rng = _card_index(cuda, "l2", precision)
    rows = [TIE_SRC + 128 * j for j in range(0, CARD_N // 128, 7)]
    idx.upsert(rows, np.repeat(x[TIE_SRC][None], len(rows), 0))
    qs = np.concatenate([_queries(rng, x, 24), x[TIE_SRC][None] + 1e-3 * rng.standard_normal(
        (8, x.shape[1])).astype(np.float32)])
    masks = _masks(rng, idx, 8)
    for masked in (None, masks):
        want = _whole_all(idx, qs, 4, masked)
        _assert_bits(_search_all(idx, qs, 4, masked), want)
    assert ttopk.LAUNCHES["flat_graph_capture"] > 0


@pytest.mark.cuda
def test_replay_equals_eager_after_each_mutation(cuda, monkeypatch):
    idx, x, rng = _card_index(cuda)
    qs = _queries(rng, x, 32)
    _search_all(idx, qs[:8], 4)  # the key recorded and captured
    c = idx.corpus

    def delete():
        hits = idx.search_arrays(qs[:8], K)[2]
        idx.delete(sorted({int(p) for p in hits[:, :3].ravel()}))

    steps = [
        ("upsert", False, lambda: idx.upsert(list(range(50)), qs[:32].repeat(2, 0)[:50])),
        ("delete", False, delete),
        ("reuse", False, lambda: idx.upsert(list(range(60_000, 60_020)), qs[:20] + 0.001)),
        ("append", False, lambda: idx.upsert(list(range(70_000, 70_100)), x[:100])),
        ("cross_grain", True, lambda: idx.upsert(list(range(80_000, 90_000)), x[:10_000])),
        ("growth", True, lambda: idx.upsert(list(range(100_000, 120_000)), x[:20_000])),
        ("compact", True, lambda: (idx.delete(list(range(1000, 3000))), idx.compact())),
    ]
    for name, replaced, mutate in steps:
        ident, cap = _ident(idx), c.capacity
        mutate()
        assert (_ident(idx) != ident) is replaced, name
        assert (c.capacity != cap) is (name in ("growth", "compact")), name
        want = _eager(monkeypatch, idx, qs, 4)
        _assert_bits(want, _whole_all(idx, qs, 4))
        before = _graph_counts()
        got = _search_all(idx, qs, 4)
        _assert_bits(got, want)
        n = len(qs) // 4
        recaptured = ttopk.LAUNCHES["flat_graph_capture"] - before["flat_graph_capture"]
        replayed = ttopk.LAUNCHES["flat_graph"] - before["flat_graph"]
        assert (recaptured, replayed) == ((1, n - 1) if replaced else (0, n)), name


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["exact", "b64", "short_table"])
def test_other_routes_run_eagerly(cuda, monkeypatch, route):
    """Exact, K2 at B = 64 and auto's exact scan of a table shorter than
    MIN_FUSED_N never ask the cache."""
    if route == "short_table":
        monkeypatch.setattr(ttopk, "MIN_FUSED_N", 1 << 20)
    idx, x, rng = _card_index(cuda)
    b = 64 if route == "b64" else 4
    qs = _queries(rng, x, 4 * b)
    before = _graph_counts()
    _search_all(idx, qs, b, mode="exact" if route == "exact" else "auto")
    assert _graph_counts() == before
    assert len(_graphs(idx)) == 0


@pytest.mark.cuda
def test_a_held_key_runs_eagerly_in_another_thread(cuda, monkeypatch):
    idx, x, rng = _card_index(cuda, "cosine")
    qs = _queries(rng, x, 4)
    want = _eager(monkeypatch, idx, qs, 1)
    _search_all(idx, qs[:2], 1)  # recorded, captured
    inside, go = threading.Event(), threading.Event()
    real = flat_mod.to_host

    def to_host(d, s):  # the replaying thread holds its entry here
        if threading.current_thread().name == "replayer":
            inside.set()
            assert go.wait(60)
        return real(d, s)

    monkeypatch.setattr(flat_mod, "to_host", to_host)  # the search skeleton's copy down
    out = {}

    def replayer():
        out["replayer"] = idx.search_arrays(qs[2:3], K)

    th = threading.Thread(target=replayer, name="replayer")
    th.start()
    try:
        assert inside.wait(60)
        before = _graph_counts()
        out["main"] = idx.search_arrays(qs[3:4], K)
        assert _graph_counts() == before  # the held key: this search ran eagerly
    finally:
        go.set()
        th.join(60)
    assert not th.is_alive()
    _assert_bits(out["replayer"][:2], (want[0][2:3], want[1][2:3]))
    _assert_bits(out["main"][:2], (want[0][3:4], want[1][3:4]))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_launch_counts_per_search_equal_on_both_paths(cuda, monkeypatch, masked):
    idx, x, rng = _card_index(cuda, "dot", "int8")
    qs = _queries(rng, x, 12)
    masks = _masks(rng, idx, 3) if masked else None
    _search_all(idx, qs[:8], 4, masks)  # recorded, captured

    def delta(fn):
        t0 = dict(ttopk.LAUNCHES)
        fn()
        return {k: ttopk.LAUNCHES[k] - t0[k] for k in t0 if k not in GRAPH_KEYS}

    eager = delta(lambda: _eager(monkeypatch, idx, qs[8:], 4, masks and masks[2:]))
    replay = delta(lambda: _search_all(idx, qs[8:], 4, masks and masks[2:]))
    assert replay == eager
    assert eager["lane_topk_acc"] == 1 and eager["select_topk"] == 2
