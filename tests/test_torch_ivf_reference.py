"""The port's IVF probe against the plain reference of its contract
(tests/torch_ivf_reference.py): the exact top-k of the live rows in the
nprobe slices that the index's own centroids select.

On the CPU the rows and queries lie on a grid on which every product and
every partial sum of a score is exact in float32 (entries of +-1 and +-2,
norms of 8 and 16, so that a cosine row or query of unit length has
entries of +-1/8): the port and the float64 reference then compute the
same scores, so slots and their order, ties included, must agree bit for
bit, and a distance may differ only by the port's last rounding of it to
float32. The trained centroids are snapped to a grid too, and the layout
rebuilt from them by the index's own build: the port scores centroids in
float32, and two centroid scores within its rounding of each other would
let either slice be probed. The grid makes exact ties common (equal
scores, equal centroid scores, and a sliced fat cluster of copies of one
row), so the rules that the lower slice and the earlier candidate win are
tested on every search.

A planted fault, the port probing half of its slices, must fail the same
comparison: that is the fault the benchmark's recall check (`miss`)
cannot see at its cell's size.

The case on the card (marker `cuda`) builds the benchmark's IVF
deployment (`benchmark/configs/cohere768-1m-ivf.json`) through the
benchmark's own loader, and holds the engine's answers to the reference
within near-ties. This file imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ivf_reference.py
"""

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ivf_reference as R
from tostore_tpu_torch import IVFVectorIndex, ToStoreTPU
from tostore_tpu_torch.models.schema import (
    DataType,
    FieldSchema,
    IndexSchema,
    TableSchema,
    VectorFieldConfig,
    VectorIndexConfig,
)

torch.set_num_threads(1)

N, D, C, NPROBE = 20000, 64, 64, 4
METRICS = ["cosine", "l2", "dot"]
# the port rounds each distance to float32 once (l2: its square root); the
# scores before it are exact on the grid
DIST_RTOL = 2.0**-23
BENCH = Path(__file__).resolve().parent.parent / "benchmark"


def _grid(seed, n=N, modes=256, flip=0.25):
    """Rows of +-1 or +-2 in every entry: sign patterns of `modes` modes,
    each entry flipped with probability `flip`, each row scaled by 1 or 2.
    The modes are weak, so a query's best rows spread over several
    clusters and the probe budget decides the answer."""
    rng = np.random.default_rng(seed)
    signs = rng.choice([-1.0, 1.0], (modes, D))
    x = signs[rng.integers(0, modes, n)]
    x = np.where(rng.random((n, D)) < flip, -x, x) * rng.choice([1.0, 2.0], (n, 1))
    return x.astype(np.float32), rng


def _queries(rng, x, b=24):
    """Rows' sign patterns with a tenth of their entries flipped."""
    q = np.sign(x[rng.integers(0, len(x), b)])
    return np.where(rng.random(q.shape) < 0.1, -q, q).astype(np.float32)


class Built:
    """An index of the port and what the reference reads of it and of the
    data: the rows by slot as the field stores them, the live slots."""

    def __init__(self, idx, x, slots, precision):
        self.idx, self.x = idx, x
        self.pk_of = {int(s): pk for pk, s in enumerate(np.asarray(slots).tolist())}
        cap = idx.corpus.capacity
        self.rows = torch.zeros((cap, D), dtype=R.ROW_TYPES[precision])
        self.rows[torch.as_tensor(np.asarray(slots, np.int64))] = R.stored_rows(
            torch.from_numpy(x), idx.metric, precision)
        self.live = torch.zeros(cap, dtype=torch.bool)
        self.live[torch.as_tensor(np.asarray(slots, np.int64))] = True
        self.precision = precision

    def delete(self, pks):
        gone = set(pks)
        slots = [s for s, pk in self.pk_of.items() if pk in gone]
        assert self.idx.delete(pks) == len(pks)
        self.live[torch.as_tensor(slots)] = False

    def reference(self, q, k, nprobe=NPROBE, slot_mask=None):
        idx = self.idx
        valid = self.live if slot_mask is None else self.live & slot_mask
        d, s = R.probe_topk(torch.from_numpy(q), self.rows, valid, idx.centroids[:, :D],
                            torch.as_tensor(idx._slice_cluster), idx.buckets_slots,
                            metric=idx.metric, nprobe=nprobe, k=k, precision=self.precision)
        return d.numpy(), s.numpy()


def _snap(idx):
    """The trained centroids to multiples of 2^-9 (cosine) or 2^-6, on
    which every centroid score is exact in float32, and the layout rebuilt
    from them by the index's own build."""
    step = 2.0**-9 if idx.metric == "cosine" else 2.0**-6
    idx.centroids = torch.round(idx.centroids / step) * step
    idx._rebuild_buckets()


def _build(metric, seed=0, precision="bfloat16", extra=None, route="raw"):
    x, rng = _grid(seed)
    if extra is not None:
        x = np.concatenate([x, extra])
    idx = IVFVectorIndex(D, metric, precision, num_clusters=C, nprobe=NPROBE,
                         min_train_size=100, device="cpu")
    slots = idx.upsert(list(range(len(x))), x)
    assert idx.trained and idx.centroids.shape[0] == C
    _snap(idx)
    if route == "raw_gather":
        idx.CONTIG_MAX_BYTES = 0
        idx._refresh_bucket_vectors()
    assert (idx.bucket_vectors is not None) == (route == "raw")
    return Built(idx, x, slots, precision), rng


def _assert_same(got_d, got_s, ref_d, ref_s):
    """Slots and order bit for bit; distances to the port's float32
    rounding; no hit where the reference has none."""
    np.testing.assert_array_equal(got_s, ref_s)
    assert np.array_equal(np.isinf(got_d), np.isinf(ref_d))
    fin = np.isfinite(ref_d)
    np.testing.assert_allclose(got_d[fin], ref_d[fin], rtol=DIST_RTOL, atol=0)


def _check(b, q, k, nprobe=None, slot_mask=None, ref_nprobe=None):
    got_d, got_s, got_pk = b.idx.search_arrays(q, k, slot_mask=slot_mask, nprobe=nprobe,
                                                mode="probe")
    ref_d, ref_s = b.reference(q, k, ref_nprobe or nprobe or NPROBE, slot_mask)
    _assert_same(got_d, got_s, ref_d, ref_s)
    assert [[b.pk_of.get(int(s)) for s in row] for row in ref_s] == got_pk.tolist()


# ----------------------------------------------------------------------------
# the reference itself
# ----------------------------------------------------------------------------


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse(Path(R.__file__).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "contextlib", "math", "torch"}, names


def test_all_slices_probed_is_the_exact_top_k():
    b, rng = _build("l2", seed=5)
    q = _queries(rng, b.x, 6)
    ref_d, ref_s = b.reference(q, 50, nprobe=b.idx.centroids_exp.shape[0])
    exact = R.distances_of(torch.from_numpy(q), b.rows,
                           torch.arange(len(b.rows)).expand(len(q), -1).clone(), metric="l2")
    want = np.sort(np.where(b.live.numpy()[None, :], exact.numpy(), np.inf), axis=1)[:, :50]
    np.testing.assert_array_equal(ref_d, want)
    assert (ref_d >= 0).all() and (np.diff(ref_d, axis=1) >= 0).all()


def test_probe_selection_spreads_a_cluster_over_its_slices():
    cents = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    q = torch.tensor([[0.0, 2.0]])
    # cluster 1 owns slices 1 and 2, cluster 0 slice 0, slice 3 is padding
    probe = R.select_probes(q, cents, torch.tensor([0, 1, 1, -1]), "dot", 4)
    assert probe.tolist() == [[1, 2, 0, 3]]


# ----------------------------------------------------------------------------
# the port against the reference
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["raw", "raw_gather"])
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("metric", METRICS)
def test_search_arrays_equals_the_reference(metric, k, route):
    b, rng = _build(metric, seed=len(metric) + k, route=route)
    _check(b, _queries(rng, b.x), k)


@pytest.mark.parametrize("metric", METRICS)
def test_search_equals_the_reference(metric):
    b, rng = _build(metric, seed=11)
    for q in _queries(rng, b.x, 6):
        ref_d, ref_s = b.reference(q[None, :], 10)
        hits = b.idx.search(q, top_k=10, mode="probe")
        assert [h.primary_key for h in hits] == [b.pk_of[int(s)] for s in ref_s[0]]
        np.testing.assert_allclose([h.distance for h in hits], ref_d[0], rtol=DIST_RTOL, atol=0)


@pytest.mark.parametrize("metric", METRICS)
def test_fat_cluster_over_several_slices(metric):
    # 2,500 copies of one row: every copy lands in one cluster, which then
    # spans several slices of one centroid score; a query at the copies
    # ties on all of them, and the lower slice's rows come first
    x, rng = _grid(21)
    copies = np.repeat(x[:1] * 2, 2500, axis=0)
    b, rng = _build(metric, seed=21, extra=copies)
    counts = np.bincount(b.idx._slice_cluster[b.idx._slice_cluster >= 0])
    assert counts.max() >= 3, counts
    q = np.concatenate([np.sign(copies[:2]), _queries(rng, b.x, 6)])
    for k in (10, 100):
        _check(b, q, k)


@pytest.mark.parametrize("metric", METRICS)
def test_deleted_rows_are_no_candidates(metric):
    b, rng = _build(metric, seed=31)
    q = _queries(rng, b.x, 12)
    found = b.idx.search_arrays(q, 10, mode="probe")[2]
    gone = sorted({pk for row in found for pk in row[:5]} | set(range(0, N, 7)))
    b.delete(gone)
    _check(b, q, 10)
    _check(b, q, 100)


@pytest.mark.parametrize("metric", METRICS)
def test_slot_mask_and_k_above_the_live_candidates(metric):
    b, rng = _build(metric, seed=41)
    q = _queries(rng, b.x, 12)
    cap = b.idx.corpus.capacity
    half = torch.from_numpy(np.random.default_rng(1).random(cap) < 0.5)
    _check(b, q, 10, slot_mask=half)
    # 1 slot in 100 kept: fewer live rows in 4 probed slices than k = 100,
    # so each answer ends in misses (slot -1, distance inf)
    few = torch.from_numpy(np.random.default_rng(2).random(cap) < 0.01)
    got_d, got_s, _ = b.idx.search_arrays(q, 100, slot_mask=few, mode="probe")
    assert (got_s[:, -1] == -1).all() and np.isinf(got_d[:, -1]).all()
    _check(b, q, 100, slot_mask=few)


@pytest.mark.parametrize("precision", ["float32"])
def test_float32_field_equals_the_reference(precision):
    b, rng = _build("cosine", seed=51, precision=precision)
    _check(b, _queries(rng, b.x), 100)


@pytest.mark.parametrize("metric", METRICS)
def test_half_the_slices_probed_fails_the_comparison(metric):
    """The planted fault: the port probes 2 slices where the contract says
    4. The comparison must fail, on most queries."""
    b, rng = _build(metric, seed=61)
    q = _queries(rng, b.x)
    with pytest.raises(AssertionError):
        _check(b, q, 10, nprobe=NPROBE // 2, ref_nprobe=NPROBE)
    got = b.idx.search_arrays(q, 10, nprobe=NPROBE // 2, mode="probe")[1]
    ref = b.reference(q, 10)[1]
    assert (got != ref).any(axis=1).mean() >= 0.5


def _engine(metric, x):
    vconf = VectorIndexConfig(index_type="ivf", metric="innerProduct" if metric == "dot" else metric,
                              num_clusters=C, nprobe=NPROBE)
    schema = TableSchema(
        name="docs",
        fields=(FieldSchema("n", DataType.integer),
                FieldSchema("emb", DataType.vector,
                            vector_config=VectorFieldConfig(dimensions=D, precision="bfloat16"))),
        indexes=(IndexSchema(fields=("emb",), type="vector", vector_config=vconf),),
    )
    db = ToStoreTPU.memory(schemas=[schema], device="cpu")
    res = db.batch_insert("docs", [{"id": i + 1, "n": i, "emb": x[i]} for i in range(len(x))])
    assert res.is_success
    db.vector_search("docs", "emb", x[0], top_k=1)  # flush the rows to the index
    assert db.engine.run_vector_maintenance() == 1  # the engine's own training
    return db


@pytest.mark.parametrize("metric", METRICS)
def test_engine_vector_search_equals_the_reference(metric):
    x, rng = _grid(71)
    db = _engine(metric, x)
    try:
        idx = db.engine._table("docs").vector_index_for("emb")
        assert idx.trained and idx.bucket_vectors is not None
        _snap(idx)
        pk_slot = dict(idx.corpus._pk_slot)
        slots = np.array([pk_slot[i + 1] for i in range(len(x))])
        b = Built(idx, x, slots, "bfloat16")
        for q in _queries(rng, x, 8):
            for k in (10, 100):
                ref_d, ref_s = b.reference(q[None, :], k)
                hits = db.vector_search("docs", "emb", q, top_k=k)
                assert [h.primary_key for h in hits] == [b.pk_of[int(s)] + 1 for s in ref_s[0]]
                np.testing.assert_allclose([h.distance for h in hits], ref_d[0],
                                           rtol=DIST_RTOL, atol=0)
    finally:
        db.close()


# ----------------------------------------------------------------------------
# on the card, at the IVF cell's size
# ----------------------------------------------------------------------------

# The reference rounds each row normalised in float64, the port's corpus
# normalised in float32: at 1M x 768 a few thousand rows differ by one
# bf16 step in one entry, which moves a cosine score by up to ~3e-4 (the
# benchmark's `dist_err` limit, 4e-4, stands on the same readings). Two
# hits whose reference distances lie within this of each other are a
# near-tie, in either order.
CARD_TOL = 4e-4
# The port scores centroids in float32 (~1e-6 at these scores): a slice
# whose centroid score lies this close to the nprobe-th is a near-tie too.
CENTROID_TOL = 1e-5
CARD_SEED = 2**31 + 1717


def _card_disagreements(b_rows, q, got_s, got_d, ref_s, ref_d, slice_sc, nprobe, slice_of,
                        metric):
    """Per query, whether the port's answer breaks the contract beyond
    near-ties: a hit twice, or in a slice whose centroid score lies below
    the nprobe-th by more than CENTROID_TOL; a hit whose reference
    distance lies farther than the reference's hit at its place by more
    than CARD_TOL; a distance off the reference's for its slot by more than
    CARD_TOL. Also per query the share of slots equal to the bit and the
    largest such gap."""
    got_ref = R.distances_of(q, b_rows, torch.from_numpy(got_s), metric=metric).cpu().numpy()
    both_inf = np.isinf(got_ref) & np.isinf(ref_d)
    gap = np.where(both_inf, 0.0, np.abs(got_ref - ref_d))
    off = np.where(np.isinf(got_ref) & np.isinf(got_d), 0.0, np.abs(got_d - got_ref))
    floor = np.sort(slice_sc, axis=1)[:, -nprobe] - CENTROID_TOL
    bad = np.zeros(len(q), bool)
    for i in range(len(q)):
        hit = got_s[i][got_s[i] >= 0]
        bad[i] = (len(set(hit.tolist())) != len(hit)
                  or bool((slice_sc[i][slice_of[hit]] < floor[i]).any())
                  or bool((slice_of[hit] < 0).any()))
    bad |= (gap > CARD_TOL).any(1) | (off > CARD_TOL).any(1) | np.isnan(gap).any(1)
    return bad, (got_s == ref_s).mean(1), gap.max(1)


def _deployment_comparison(config, device, seed, n_queries):
    """The benchmark's IVF deployment of `config` in the engine, loaded and
    trained as the benchmark does; `n_queries` queries of its mixture and
    as many standard normal ones, at the configuration's nprobe and at
    half of it, each answer held to the reference at the configuration's
    nprobe. Returns {nprobe: {query set: answers beyond near-ties}}."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from vdbbench import datagen, system

    metric, prec, k = config["metric"], config["precision"], config["top_k"]
    nprobe, dims = config["index"]["nprobe"], config["dims"]
    mix = datagen.Mixture(config["data"], dims, seed, device)
    sut = system.EngineTable(config, device)
    failed = {}
    try:
        sut.load(mix.rows(config["rows"]))
        sut.wait_trained(float(config["train_wait_s"]))
        idx = sut.index()
        pk_slot = idx.corpus._pk_slot
        rows = torch.zeros((idx.corpus.capacity, dims), dtype=R.ROW_TYPES[prec], device=device)
        for off, x in mix.rows(config["rows"]):
            at = torch.tensor([pk_slot[off + i + 1] for i in range(len(x))], device=device)
            rows[at] = R.stored_rows(x, metric, prec)
        valid = torch.zeros(idx.corpus.capacity, dtype=torch.bool, device=device)
        valid[torch.tensor(list(pk_slot.values()), device=device)] = True
        buckets = idx.buckets_slots
        slice_of = torch.full((idx.corpus.capacity,), -1, dtype=torch.int64, device=device)
        placed = buckets >= 0
        slice_of[buckets[placed]] = torch.nonzero(placed)[:, 0]
        slice_of = slice_of.cpu().numpy()
        cents, slice_cluster = idx.centroids[:, :dims], torch.as_tensor(idx._slice_cluster)
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        sets = {"mixture": mix.queries(n_queries).cpu(),
                "normal": torch.randn((n_queries, dims), generator=g, device=device).cpu()}
        for planted in (nprobe, nprobe // 2):
            failed[planted] = {}
            for name, q in sets.items():
                got_s = np.full((len(q), k), -1, np.int64)
                got_d = np.full((len(q), k), np.inf)
                for i, qi in enumerate(q.numpy()):
                    hits = sut.db.vector_search(sut.table, sut.field, qi, top_k=k,
                                                nprobe=planted)
                    got_s[i, : len(hits)] = [pk_slot[h.primary_key] for h in hits]
                    got_d[i, : len(hits)] = [h.distance for h in hits]
                ref_d, ref_s = R.probe_topk(q, rows, valid, cents, slice_cluster, buckets,
                                            metric=metric, nprobe=nprobe, k=k, precision=prec)
                with R.no_tf32():
                    qd = R.queries_of(q.to(device), metric, prec)[0]
                    slice_sc = R.slice_scores(qd, cents, slice_cluster.to(device),
                                              metric).cpu().numpy()
                bad, same, gap = _card_disagreements(rows, q, got_s, got_d, ref_s.cpu().numpy(),
                                                     ref_d.cpu().numpy(), slice_sc, nprobe,
                                                     slice_of, metric)
                failed[planted][name] = int(bad.sum())
                print(f"{device} nprobe {planted} {name}: answers beyond near-ties "
                      f"{int(bad.sum())} of {len(q)}; slots equal to the bit {same.mean():.6f} "
                      f"(every slot in {int((same == 1).sum())} answers); widest gap "
                      f"{gap.max():.6g}; slices {buckets.shape[0]}, cap {buckets.shape[1]}",
                      flush=True)
    finally:
        sut.close()
    return failed


def test_deployment_comparison_at_a_small_size():
    """The card case's comparison on the CPU, at a small size of the same
    recipe: sound at nprobe 4, failing at 2."""
    config = json.loads((BENCH / "configs" / "cohere768-1m-ivf.json").read_text())
    config.update(rows=16384, load_chunk=4096, train_wait_s=60,
                  data={**config["data"], "modes": 16},
                  index={**config["index"], "num_clusters": 16, "nprobe": 4})
    failed = _deployment_comparison(config, "cpu", 2**31 + 5, 24)
    assert failed[4] == {"mixture": 0, "normal": 0}, failed
    assert sum(failed[2].values()) > 0, failed


@pytest.mark.cuda
def test_ivf_cell_size_equals_the_reference_on_the_card():
    """1M x 768 bf16 rows of the benchmark's recipe in the engine, trained
    by its maintenance job; 256 queries of the cell's mixture and 256 far
    from every mode (standard normal); k = 100 at nprobe 16, and at a
    planted nprobe 8, which must fail."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for sm_90a")
    config = json.loads((BENCH / "configs" / "cohere768-1m-ivf.json").read_text())
    nprobe = config["index"]["nprobe"]
    failed = _deployment_comparison(config, "cuda", CARD_SEED, 256)
    assert failed[nprobe] == {"mixture": 0, "normal": 0}, failed
    assert sum(failed[nprobe // 2].values()) > 0, failed
