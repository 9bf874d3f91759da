"""The IVF probe's stages as CUDA graphs (`ops/graphs.py`, used by
`IVFVectorIndex._probe` in vector/ivf.py).

On the CPU: which searches may take the graph path (a pure function of
the device, the route, the mask and the batch), the key's tensor
identities (stable without a mutation and under in-place writes, new
after a retrain, a compaction, an upsert that retrains and a slice
growth), the old layout freed wherever the index replaces it, the
counters moving only once a search's stages ran, the cache's locking,
staleness and eviction (recorded keys least recently used first, captured
ones never), the launch recording a replay adds, and no graph counter
moving on the CPU.

On the card (marker `cuda`): replayed answers equal the eager probe's
bit for bit, in distances and slots, over 256 queries at B = 1, 4 and 32,
for every metric and field precision; the same after each mutation, with a
capture wherever the key changed; masked, PQ, gather and B = 64 searches
run eagerly; a search that finds its key held by another thread runs
eagerly; per-search launch counts equal on both paths. This file imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ivf_graph.py
"""

import gc
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

import tostore_tpu_torch.ops.ivfprobe as tivf
import tostore_tpu_torch.ops.topk as ttopk
import tostore_tpu_torch.vector.ivf as ivf_mod
from tostore_tpu_torch import IVFVectorIndex
from tostore_tpu_torch.ops import _kernels, graphs

torch.set_num_threads(1)

GRAPH_KEYS = ("ivf_probe_graph", "ivf_probe_graph_capture")
K = 10


def _rows(rng, n, d, centers=24):
    c = rng.standard_normal((centers, d)).astype(np.float32) * 3
    return (c[rng.integers(0, centers, n)] + rng.standard_normal((n, d))).astype(np.float32)


def _index(device, metric="l2", precision="bfloat16", n=6000, d=32, clusters=16, nprobe=4,
           pq=0, seed=0):
    rng = np.random.default_rng(seed)
    x = _rows(rng, n, d)
    idx = IVFVectorIndex(d, metric, precision, num_clusters=clusters, nprobe=nprobe,
                         pq_subspaces=pq, pq_centroids=16 if pq else 0, min_train_size=100,
                         device=device)
    idx.upsert(list(range(n)), x)
    assert idx.trained
    return idx, x, rng


def _ident(idx):
    return graphs.identities(idx._probe_graph_tensors())


def _graph_counts():
    return {k: tivf.LAUNCHES[k] for k in GRAPH_KEYS}


# --------------------------------------------------------------------------
# CPU: the path decision and the key
# --------------------------------------------------------------------------


@pytest.mark.parametrize("device,raw_contig,masked,b,want", [
    ("cuda", True, False, 1, True),
    ("cuda", True, False, 32, True),
    ("cuda:1", True, False, 4, True),
    ("cpu", True, False, 1, False),      # CPU tensors
    ("cuda", True, True, 1, False),      # a slot mask
    ("cuda", False, False, 1, False),    # PQ or gather routes
    ("cuda", True, False, 33, False),    # B > 32
    ("cuda", True, False, 64, False),
])
def test_graph_path_decision(device, raw_contig, masked, b, want):
    assert ivf_mod._probe_graph_eligible(torch.device(device), raw_contig, masked, b) is want


@pytest.mark.parametrize("route", ["raw", "gather", "pq"])
def test_only_the_raw_contiguous_route_is_a_graph_route(route):
    """The route flag `_probe` passes: PQ and gather indexes give False."""
    idx, _, _ = _index("cpu", pq=8 if route == "pq" else 0)
    if route == "gather":
        idx.CONTIG_MAX_BYTES = 0
        idx._refresh_bucket_vectors()
    pq = idx.pq is not None and (idx.bucket_codes is not None or idx.codes is not None)
    assert (not pq and idx.bucket_vectors is not None) is (route == "raw")


def test_key_stable_without_mutation_and_under_in_place_writes():
    idx, x, rng = _index("cpu")
    ident = _ident(idx)
    assert all(t is not None for t in ident[:5] + ident[6:])  # bf16: no scales
    for i in range(3):
        idx.search_arrays(x[i: i + 2], K, mode="probe")
        assert _ident(idx) == ident
    idx.delete(list(range(0, 300, 7)))  # vacates bucket entries in place
    assert _ident(idx) == ident
    idx.upsert(list(range(10_000, 10_040)), x[:40] + 0.01)  # appends into free bucket rows
    assert _ident(idx) == ident


def _overflow(idx, x, rng):
    """Upsert more rows near one row than its three nearest clusters hold:
    the append path rebuilds the slices."""
    cap = idx.buckets_slots.shape[1]
    n = 4 * cap * int(idx._slice_count.max())
    near = x[5] + 0.01 * rng.standard_normal((n, x.shape[1])).astype(np.float32)
    idx.upsert(list(range(20_000, 20_000 + n)), near)


@pytest.mark.parametrize("mutation", ["train", "compact", "retraining_upsert", "slice_growth"])
def test_key_changes_when_a_captured_tensor_is_replaced(mutation):
    idx, x, rng = _index("cpu", n=2000)
    ident = _ident(idx)
    if mutation == "train":
        idx.train(force=True)
    elif mutation == "compact":
        idx.delete(list(range(0, 2000, 3)))
        idx.compact()
    elif mutation == "retraining_upsert":  # 4x the trained size retrains inline
        idx.upsert(list(range(5000, 13_000)), _rows(rng, 8000, x.shape[1]))
    else:
        _overflow(idx, x, rng)
    assert _ident(idx) != ident


def test_no_graph_counter_moves_on_the_cpu():
    idx, x, _ = _index("cpu")
    before = _graph_counts()
    for i in range(4):
        idx.search_arrays(x[i: i + 1], K, mode="probe")
        idx.search(x[i], top_k=K, mode="probe")
    assert _graph_counts() == before
    assert len(idx._probe_graphs) == 0  # the cache is never asked on the CPU


def _replace_layout(idx, x, rng, how):
    if how == "train":
        idx.train(force=True)
    elif how == "compact":
        idx.delete(list(range(0, 2000, 3)))
        idx.compact()
    elif how == "slice_growth":
        _overflow(idx, x, rng)
    elif how == "refresh":
        idx._refresh_bucket_vectors()
    elif how == "install_retrained":
        cap = idx.capture_build_state()
        assert idx.install_retrained(cap, idx.build_retrained(cap))
    else:
        idx.delete(list(range(0, 2000, 3)))
        cap = idx.capture_compact_state()
        assert idx.install_compacted(cap, idx.build_compacted(cap))


@pytest.mark.parametrize("how", ["train", "compact", "slice_growth", "refresh",
                                 "install_retrained", "install_compacted"])
def test_replacing_the_layout_frees_the_captured_tensors(how):
    """An entry holds the tensors its graphs read. Where the index replaces
    them it drops its entries, so the old layout is freed at once, with no
    search in between (a later search may never take the graph path)."""
    idx, x, rng = _index("cpu", n=2000)
    idx._probe_graphs.acquire((1, K, 4, "l2"), idx._probe_graph_tensors())  # as on the card
    assert len(idx._probe_graphs) == 1
    old = weakref.ref(idx.bucket_vectors)
    _replace_layout(idx, x, rng, how)
    gc.collect()
    assert len(idx._probe_graphs) == 0
    assert old() is None


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.mark.parametrize("captures", [True, False])
def test_graph_counters_move_once_the_stages_ran(monkeypatch, captures):
    """A search counts as replayed (and its key as captured) after its
    stages ran: a capture that fails fails the search and counts nothing,
    and the key's later searches run eagerly."""
    idx, x, _ = _index("cpu")

    def capture(self, fn):
        if not captures:
            raise RuntimeError("capture failed")
        return _FakeGraph(), fn(), []

    monkeypatch.setattr(ivf_mod, "_probe_graph_eligible", lambda *a: True)
    monkeypatch.setattr(graphs.StageGraphs, "_capture", capture)
    before = _graph_counts()
    idx.search_arrays(x[:2], K, mode="probe")  # the key recorded: eager
    assert _graph_counts() == before
    if captures:
        idx.search_arrays(x[2:4], K, mode="probe")
        idx.search_arrays(x[4:6], K, mode="probe")
        assert _graph_counts() == {"ivf_probe_graph": before["ivf_probe_graph"] + 2,
                                   "ivf_probe_graph_capture":
                                       before["ivf_probe_graph_capture"] + 1}
    else:
        with pytest.raises(RuntimeError):
            idx.search_arrays(x[2:4], K, mode="probe")
        idx.search_arrays(x[4:6], K, mode="probe")  # the broken key: eager
        assert _graph_counts() == before


# --------------------------------------------------------------------------
# CPU: the cache and the launch recording
# --------------------------------------------------------------------------


def test_cache_records_then_locks_an_entry():
    cache, held = graphs.GraphCache(), (torch.zeros(4), None)
    assert cache.acquire("k", held) is None and len(cache) == 1  # first search: eager
    entry = cache.acquire("k", held)
    assert isinstance(entry, graphs.StageGraphs) and entry.lock.locked()
    assert entry.held is held and not entry.captured
    assert cache.acquire("k", held) is None  # held by another search: eager
    entry.lock.release()
    again = cache.acquire("k", held)
    assert again is entry
    again.lock.release()


def test_cache_drops_entries_of_replaced_tensors():
    a, b = torch.zeros(4), torch.zeros(4)
    cache = graphs.GraphCache()
    for key in ("x", "y"):
        cache.acquire(key, (a,))
    assert len(cache) == 2
    a.add_(1)  # an in-place write keeps the key
    entry = cache.acquire("x", (a,))
    assert entry is not None
    entry.lock.release()
    assert cache.acquire("x", (b,)) is None  # a replaced tensor: a miss
    assert len(cache) == 1  # both entries of `a` dropped, the new key recorded
    assert cache.acquire("x", (a[:2],)) is None  # another shape of the same memory
    assert len(cache) == 1


def test_cache_evicts_the_oldest_past_its_limit():
    t = torch.zeros(2)
    cache = graphs.GraphCache()
    n = graphs.MAX_ENTRIES + 2
    for key in range(n):
        cache.acquire(key, (t,))
    assert len(cache) == graphs.MAX_ENTRIES
    assert cache.acquire(0, (t,)) is None  # evicted: recorded again
    entry = cache.acquire(n - 1, (t,))
    assert entry is not None
    entry.lock.release()


def test_captured_entries_stay_and_keys_past_them_run_eagerly():
    """A captured entry is never evicted, so a set of tensors pays at most
    MAX_ENTRIES captures: a new key takes the place of a key recorded but
    not captured, and where every entry is captured it is not recorded at
    all and never captures."""
    t = torch.zeros(2)
    cache = graphs.GraphCache()
    for key in range(graphs.MAX_ENTRIES):
        cache.acquire(key, (t,))
        entry = cache.acquire(key, (t,))
        if key:
            entry._graphs.append(None)  # as after its capture
        entry.lock.release()
    assert cache.acquire("new", (t,)) is None  # takes key 0's place: 0 was never captured
    entry = cache.acquire("new", (t,))
    entry._graphs.append(None)
    entry.lock.release()
    for _ in range(3):  # no room now: not recorded
        assert cache.acquire(0, (t,)) is None
    assert len(cache) == graphs.MAX_ENTRIES
    assert sorted(map(str, (k for k, _ in cache._entries))) == sorted(
        map(str, ["new", *range(1, graphs.MAX_ENTRIES)]))
    for key in ["new", *range(1, graphs.MAX_ENTRIES)]:
        entry = cache.acquire(key, (t,))
        assert entry is not None, key
        entry.lock.release()


def test_cache_keeps_a_key_in_use_past_the_limit():
    """Least recently used first: a key searched between new keys stays."""
    t = torch.zeros(2)
    cache = graphs.GraphCache()
    cache.acquire("hot", (t,))
    for key in range(3 * graphs.MAX_ENTRIES):
        cache.acquire(key, (t,))
        entry = cache.acquire("hot", (t,))
        assert entry is not None, key
        entry.lock.release()
    assert len(cache) == graphs.MAX_ENTRIES


def test_stage_captures_once_and_each_replay_adds_the_recorded_launches(monkeypatch):
    made = []

    def capture(self, fn):
        out = fn()
        made.append(_FakeGraph())
        return made[-1], out, [(tivf.LAUNCHES, "ivf_bucket_probe", 1),
                               (ttopk.LAUNCHES, "select_topk", 2)]

    monkeypatch.setattr(graphs.StageGraphs, "_capture", capture)
    entry = graphs.StageGraphs((), ())
    (qbuf,) = entry.load(torch.ones(3))
    assert entry.load(torch.full((3,), 2.0))[0] is qbuf and float(qbuf.sum()) == 6.0
    before = (tivf.LAUNCHES["ivf_bucket_probe"], ttopk.LAUNCHES["select_topk"])
    outs = [entry.stage(0, lambda: qbuf * 2) for _ in range(3)]
    assert len(made) == 1 and made[0].replays == 3 and entry.captured
    assert outs[0] is outs[1] is outs[2]
    assert (tivf.LAUNCHES["ivf_bucket_probe"], ttopk.LAUNCHES["select_topk"]) == (
        before[0] + 3, before[1] + 6)


def test_a_failed_capture_breaks_the_entry(monkeypatch):
    def capture(self, fn):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(graphs.StageGraphs, "_capture", capture)
    cache, held = graphs.GraphCache(), (torch.zeros(1),)
    cache.acquire("k", held)
    entry = cache.acquire("k", held)
    with pytest.raises(RuntimeError):
        entry.stage(0, lambda: None)
    entry.lock.release()
    assert entry.broken
    assert cache.acquire("k", held) is None and not entry.lock.locked()


def test_recording_takes_this_threads_counts_only():
    before = tivf.LAUNCHES["ivf_adc"]
    with _kernels.recording() as rec:
        _kernels.count(tivf.LAUNCHES, "ivf_adc", 2)
        other = threading.Thread(target=_kernels.count, args=(tivf.LAUNCHES, "ivf_adc"))
        other.start()
        other.join(10)
        assert not other.is_alive()
    assert rec == [(tivf.LAUNCHES, "ivf_adc", 2)]
    assert tivf.LAUNCHES["ivf_adc"] == before + 1  # the other thread's launch
    _kernels.count(tivf.LAUNCHES, "ivf_adc")
    _kernels.add(rec)
    assert tivf.LAUNCHES["ivf_adc"] == before + 4


def test_cache_stress_one_holder_at_a_time():
    """16 threads acquire one key at once, with a short switch interval:
    never two holders of an entry, and every search either held it or ran
    eagerly."""
    cache, held = graphs.GraphCache(), (torch.zeros(1),)
    cache.acquire("k", held)
    state = {"holders": 0, "most": 0, "held": 0, "eager": 0}
    mu = threading.Lock()

    def worker():
        for _ in range(300):
            entry = cache.acquire("k", held)
            if entry is None:
                with mu:
                    state["eager"] += 1
                continue
            with mu:
                state["holders"] += 1
                state["most"] = max(state["most"], state["holders"])
                state["held"] += 1
            with mu:
                state["holders"] -= 1
            entry.lock.release()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert state["most"] == 1 and state["held"] + state["eager"] == 16 * 300
    assert len(cache) == 1


# --------------------------------------------------------------------------
# The card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs of the card's kernels")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _search_all(idx, qs, b, **kw):
    d, s = [], []
    for i in range(0, len(qs), b):
        dist, slots, _ = idx.search_arrays(qs[i: i + b], K, mode="probe", **kw)
        d.append(dist)
        s.append(slots)
    return np.concatenate(d), np.concatenate(s)


def _eager(monkeypatch, idx, qs, b, **kw):
    with monkeypatch.context() as m:
        m.setattr(ivf_mod, "_probe_graph_eligible", lambda *a: False)
        return _search_all(idx, qs, b, **kw)


def _assert_bits(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))


def _queries(rng, x, n):
    return x[rng.integers(0, len(x), n)] + 0.1 * rng.standard_normal((n, x.shape[1])).astype(
        np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4, 32])
@pytest.mark.parametrize("precision", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_replay_equals_eager_bit_for_bit(cuda, monkeypatch, metric, precision, b):
    idx, x, rng = _index(cuda, metric, precision, n=20_000, d=128, clusters=64, nprobe=8)
    assert idx.bucket_vectors is not None
    qs = _queries(rng, x, 256)
    want = _eager(monkeypatch, idx, qs, b)
    before = _graph_counts()
    got = _search_all(idx, qs, b)
    _assert_bits(got, want)
    n = 256 // b
    # the first search of the key runs eagerly, the second captures
    assert _graph_counts() == {"ivf_probe_graph": before["ivf_probe_graph"] + n - 1,
                               "ivf_probe_graph_capture":
                                   before["ivf_probe_graph_capture"] + 1}


@pytest.mark.cuda
def test_replay_equals_eager_after_each_mutation(cuda, monkeypatch):
    idx, x, rng = _index(cuda, "l2", "bfloat16", n=20_000, d=128, clusters=64, nprobe=8)
    qs = _queries(rng, x, 64)
    _search_all(idx, qs[:8], 4)  # the key recorded and captured

    def delete():
        hits = idx.search_arrays(qs[:8], K, mode="probe")[2]
        idx.delete(sorted({int(p) for p in hits[:, :3].ravel()}))

    steps = [
        ("upsert", False, lambda: idx.upsert(list(range(50_000, 50_064)), qs + 0.001)),
        ("delete", False, delete),
        ("compact", True, lambda: idx.compact()),
        ("train", True, lambda: idx.train(force=True)),
        ("slice_growth", True, lambda: _overflow(idx, x, rng)),
    ]
    for name, replaced, mutate in steps:
        ident = _ident(idx)
        mutate()
        assert (_ident(idx) != ident) is replaced, name
        want = _eager(monkeypatch, idx, qs, 4)
        before = _graph_counts()
        got = _search_all(idx, qs, 4)
        _assert_bits(got, want)
        n = len(qs) // 4
        recaptured = tivf.LAUNCHES["ivf_probe_graph_capture"] - before["ivf_probe_graph_capture"]
        replayed = tivf.LAUNCHES["ivf_probe_graph"] - before["ivf_probe_graph"]
        assert (recaptured, replayed) == ((1, n - 1) if replaced else (0, n)), name


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["masked", "pq", "gather", "b64"])
def test_other_routes_run_eagerly(cuda, route):
    idx, x, rng = _index(cuda, "l2", "bfloat16", n=20_000, d=128, clusters=64, nprobe=8,
                         pq=16 if route == "pq" else 0)
    if route == "gather":
        idx.CONTIG_MAX_BYTES = 0
        idx._refresh_bucket_vectors()
    b = 64 if route == "b64" else 4
    kw = {}
    if route == "masked":
        kw["slot_mask"] = idx.corpus.valid.clone()
    qs = _queries(rng, x, 4 * b)
    before = _graph_counts()
    _search_all(idx, qs, b, **kw)
    assert _graph_counts() == before
    assert len(idx._probe_graphs) == 0


@pytest.mark.cuda
def test_a_held_key_runs_eagerly_in_another_thread(cuda, monkeypatch):
    idx, x, rng = _index(cuda, "cosine", "bfloat16", n=20_000, d=128, clusters=64, nprobe=8)
    qs = _queries(rng, x, 4)
    want = _eager(monkeypatch, idx, qs, 1)
    _search_all(idx, qs[:2], 1)  # recorded, captured
    inside, go = threading.Event(), threading.Event()
    real = ivf_mod.to_host

    def to_host(d, s):  # the replaying thread holds its entry here
        if threading.current_thread().name == "replayer":
            inside.set()
            assert go.wait(60)
        return real(d, s)

    monkeypatch.setattr(ivf_mod, "to_host", to_host)
    out = {}

    def replayer():
        out["replayer"] = idx.search_arrays(qs[2:3], K, mode="probe")

    th = threading.Thread(target=replayer, name="replayer")
    th.start()
    try:
        assert inside.wait(60)
        before = _graph_counts()
        out["main"] = idx.search_arrays(qs[3:4], K, mode="probe")
        assert _graph_counts() == before  # the held key: this search ran eagerly
    finally:
        go.set()
        th.join(60)
    assert not th.is_alive()
    _assert_bits(out["replayer"][:2], (want[0][2:3], want[1][2:3]))
    _assert_bits(out["main"][:2], (want[0][3:4], want[1][3:4]))


@pytest.mark.cuda
def test_threads_share_a_key_and_every_search_counts_its_kernels(cuda, monkeypatch):
    """8 threads x 24 searches of one key: every answer equals the eager
    one, and K3 counts one launch a search whichever path ran it."""
    idx, x, rng = _index(cuda, "l2", "bfloat16", n=20_000, d=128, clusters=64, nprobe=8)
    qs = _queries(rng, x, 24)
    want = _eager(monkeypatch, idx, qs, 1)
    _search_all(idx, qs[:2], 1)
    before = tivf.LAUNCHES["ivf_bucket_probe"]
    got = {}

    def worker(t):
        got[t] = _search_all(idx, qs, 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    for t in range(8):
        _assert_bits(got[t], want)
    assert tivf.LAUNCHES["ivf_bucket_probe"] == before + 8 * 24


@pytest.mark.cuda
def test_launch_counts_per_search_equal_on_both_paths(cuda, monkeypatch):
    idx, x, rng = _index(cuda, "dot", "int8", n=20_000, d=128, clusters=64, nprobe=8)
    qs = _queries(rng, x, 12)
    _search_all(idx, qs[:8], 4)  # recorded, captured

    def delta(fn):
        t0, i0 = dict(ttopk.LAUNCHES), dict(tivf.LAUNCHES)
        fn()
        d = {k: ttopk.LAUNCHES[k] - t0[k] for k in t0}
        d.update({k: tivf.LAUNCHES[k] - i0[k] for k in i0 if k not in GRAPH_KEYS})
        return d

    eager = delta(lambda: _eager(monkeypatch, idx, qs[8:], 4))
    replay = delta(lambda: _search_all(idx, qs[8:], 4))
    assert replay == eager
    assert eager["ivf_bucket_probe"] == 1 and eager["select_topk"] == 2
