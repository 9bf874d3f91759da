"""The port's spans on torch.profiler's timeline (`utils/spans.py`): each
stage of `Database.vector_search` as `tostore.vector_search.<stage>`,
nested in the engine's `tostore.vector_search`, in a `profile_trace`
Chrome trace, and the IVF probe's own stages (`probes`, `scan`, `select`)
inside its `dispatch` on each of its four routes; no `record_function`
entered while no profiler records; the engine's `vector_search` timer
around the whole method.

The cases on the card (marker `cuda`) also place the search's host syncs
in the stages that wait for the device, and hold a probe search that
replays the stages' CUDA graphs to the same spans. This file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

import tostore_tpu_torch.ops.ivfprobe as tivf
from tostore_tpu_torch import QueryCondition, ToStoreTPU
from tostore_tpu_torch.models.schema import (
    DataType,
    FieldSchema,
    IndexSchema,
    TableSchema,
    VectorFieldConfig,
    VectorIndexConfig,
)
from tostore_tpu_torch.utils import spans

torch.set_num_threads(1)

STAGES = ["capture", "prep", "dispatch", "wait", "results", "post"]
# CUDA calls that block the host until the device has caught up
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize",
})
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
DIMS = 16


PROBE_STAGES = ["probes", "scan", "select"]
# the IVF probe's four routes: raw rows over the contiguous copy (K3) or by
# gather, PQ codes over the contiguous copy (K4) or by gather
ROUTES = ["raw", "raw_gather", "pq", "pq_gather"]


def _schema(index_type, pq=False):
    vconf = (VectorIndexConfig(index_type="ivf", metric="l2", num_clusters=8, nprobe=4,
                               pq_subspaces=8 if pq else 0, pq_centroids=16 if pq else 0)
             if index_type == "ivf" else VectorIndexConfig(index_type="flat"))
    return TableSchema(
        name="docs",
        fields=(FieldSchema("n", DataType.integer),
                FieldSchema("emb", DataType.vector,
                            vector_config=VectorFieldConfig(dimensions=DIMS))),
        indexes=(IndexSchema(fields=("emb",), type="vector", vector_config=vconf),),
    )


def _open(index_type, device, route="raw"):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for sm_90a")
    db = ToStoreTPU.memory(schemas=[_schema(index_type, pq=route.startswith("pq"))],
                           device=device)
    x = np.random.default_rng(3).standard_normal((600, DIMS)).astype(np.float32)
    db.batch_insert("docs", [{"id": i + 1, "n": i, "emb": x[i].tolist()} for i in range(600)])
    db.vector_search("docs", "emb", x[0], top_k=1)  # flush the rows to the index
    if index_type == "ivf":
        assert db.engine.run_vector_maintenance() == 1  # the engine's own training
        idx = db.engine._table("docs").vector_index_for("emb")
        if route == "raw_gather":
            idx.CONTIG_MAX_BYTES = 0
            idx._refresh_bucket_vectors()
        elif route == "pq_gather":
            idx.bucket_codes = None
        assert (idx.bucket_vectors is not None) == (route == "raw")
        assert (idx.bucket_codes is not None) == (route == "pq")
    return db, x


@pytest.fixture
def flat_cpu():
    db, x = _open("flat", "cpu")
    yield db, x
    db.close()


class Span:
    def __init__(self, e):
        self.name, self.tid = e["name"], e.get("tid")
        self.t0 = float(e["ts"])
        self.t1 = self.t0 + float(e["dur"])
        self.children = []

    @property
    def stage(self):
        return self.name.rsplit(".", 1)[-1]


def _trace(db, tmp_path, searches):
    """The `tostore.` spans of a `profile_trace` around the searches as
    trees (roots in order), and the trace's CUDA calls."""
    out = tmp_path / "trace"
    with db.profile_trace(str(out)):
        for kw in searches:
            db.vector_search("docs", "emb", kw.pop("q"), **kw)
    (path,) = out.glob("trace_*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    marks = sorted((Span(e) for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith(spans.PREFIX)), key=lambda s: (s.t0, -s.t1))
    roots, stack = [], []
    for s in marks:
        while stack and not (stack[-1].tid == s.tid and stack[-1].t1 >= s.t1):
            stack.pop()
        (stack[-1].children if stack else roots).append(s)
        stack.append(s)
    calls = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    return roots, calls


def _stages(root):
    return [c.stage for c in root.children]


def _descendants(span):
    return [d for c in span.children for d in [c.stage, *_descendants(c)]]


def _children(root, stage):
    (s,) = [c for c in root.children if c.stage == stage]
    return [c.stage for c in s.children]


@pytest.mark.parametrize("device", DEVICES)
def test_flat_search_stages_nest_in_order(device, tmp_path):
    db, x = _open("flat", device)
    try:
        cond = QueryCondition().where("n", ">=", 300)
        roots, _ = _trace(db, tmp_path, [{"q": x[5], "top_k": 10},
                                         {"q": x[400], "top_k": 10, "condition": cond}])
    finally:
        db.close()
    assert [r.name for r in roots] == ["tostore.vector_search"] * 2
    for root, mask in zip(roots, ([], ["mask"])):
        assert _stages(root) == STAGES
        assert [_children(root, s) for s in STAGES] == [mask, [], ["bias"], [], [], []]
        times = [(c.t0, c.t1) for c in root.children]
        assert all(a1 <= b0 for (_, a1), (b0, _) in zip(times, times[1:]))
        assert not set(_descendants(root)) & set(PROBE_STAGES)  # the probe's stages


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("device", DEVICES)
def test_ivf_probe_search_stages_nest_in_order(device, route, tmp_path):
    db, x = _open("ivf", device, route)
    try:
        cond = QueryCondition().where("n", ">=", 300)
        roots, _ = _trace(db, tmp_path, [{"q": x[7], "top_k": 10, "mode": "probe"},
                                         {"q": x[400], "top_k": 10, "mode": "probe",
                                          "condition": cond}])
    finally:
        db.close()
    assert [r.name for r in roots] == ["tostore.vector_search"] * 2
    for root, mask in zip(roots, ([], ["mask"])):
        assert _stages(root) == STAGES
        # the probe's dispatch holds its three stages in order, and no flat
        # bias (the flat fallback has one); nothing nests in them
        assert [_children(root, s) for s in STAGES] == [mask, [], PROBE_STAGES, [], [], []]
        (dispatch,) = [c for c in root.children if c.stage == "dispatch"]
        assert all(c.children == [] for c in dispatch.children)
        times = [(c.t0, c.t1) for c in dispatch.children]
        assert all(a1 <= b0 for (_, a1), (b0, _) in zip(times, times[1:]))
        assert dispatch.t0 <= times[0][0] and times[-1][1] <= dispatch.t1


def test_every_timed_engine_operation_is_a_span(flat_cpu, tmp_path):
    db, x = flat_cpu
    out = tmp_path / "trace"
    with db.profile_trace(str(out)):
        db.insert("docs", {"id": 1001, "n": 1001, "emb": x[1].tolist()})
        db.query("docs").where("n", ">=", 590).fetch()
    (path,) = out.glob("trace_*.json")
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"tostore.insert", "tostore.query"} <= names


def test_no_record_function_without_a_profiler(flat_cpu, monkeypatch):
    class Refused:
        def __init__(self, *a, **kw):
            raise AssertionError("record_function entered with no profiler open")

    monkeypatch.setattr(autograd_profiler, "record_function", Refused)
    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    db, x = flat_cpu
    cond = QueryCondition().where("n", ">=", 300)
    assert db.vector_search("docs", "emb", x[400], top_k=3, condition=cond)[0].primary_key == 401
    db.insert("docs", {"id": 1001, "n": 1001, "emb": x[1].tolist()})
    assert len(db.query("docs").where("n", ">=", 590).fetch()) == 11
    assert db.vector_search("docs", "emb", x[1], top_k=1)[0].primary_key in (2, 1001)


def test_no_record_function_in_the_probe_without_a_profiler(monkeypatch):
    class Refused:
        def __init__(self, *a, **kw):
            raise AssertionError("record_function entered with no profiler open")

    db, x = _open("ivf", "cpu")
    try:
        monkeypatch.setattr(autograd_profiler, "record_function", Refused)
        monkeypatch.setattr(torch.profiler, "record_function", Refused)
        hits = db.vector_search("docs", "emb", x[400], top_k=3, mode="probe")
        assert hits[0].primary_key == 401
    finally:
        db.close()


def test_search_timer_covers_the_post_stage(flat_cpu, monkeypatch):
    db, x = flat_cpu
    real = db.engine.weights.record_access

    def slow(*a, **kw):
        time.sleep(0.05)
        return real(*a, **kw)

    monkeypatch.setattr(db.engine.weights, "record_access", slow)
    before = db.timings()["vector_search"]
    db.vector_search("docs", "emb", x[9], top_k=1)
    after = db.timings()["vector_search"]
    assert after["count"] == before["count"] + 1
    assert after["total_ms"] - before["total_ms"] >= 50.0


def test_gate_follows_the_profiler():
    assert autograd_profiler._is_profiler_enabled is False
    assert spans.span("x") is spans._OFF
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(spans.span("x"), autograd_profiler.record_function)
    assert autograd_profiler._is_profiler_enabled is False
    assert spans.span("x") is spans._OFF


@pytest.mark.cuda
def test_replayed_ivf_probe_search_stages_nest_in_order(tmp_path):
    """On the card the third probe search of one key replays the stages'
    CUDA graphs (ops/graphs.py): traced, its three probe spans still nest
    in order in `dispatch` with nothing inside them, and its host syncs
    are the two copies up (prep) and the two down (wait)."""
    db, x = _open("ivf", "cuda", "raw")
    try:
        for i in (7, 8):  # the key's first search runs eagerly, the second captures
            db.vector_search("docs", "emb", x[i], top_k=10, mode="probe")
        before = tivf.LAUNCHES["ivf_probe_graph"]
        roots, calls = _trace(db, tmp_path, [{"q": x[9], "top_k": 10, "mode": "probe"}])
        assert tivf.LAUNCHES["ivf_probe_graph"] == before + 1
    finally:
        db.close()
    (root,) = roots
    assert _stages(root) == STAGES
    assert [_children(root, s) for s in STAGES] == [[], [], PROBE_STAGES, [], [], []]
    (dispatch,) = [c for c in root.children if c.stage == "dispatch"]
    assert all(c.children == [] for c in dispatch.children)
    times = [(c.t0, c.t1) for c in dispatch.children]
    assert all(a1 <= b0 for (_, a1), (b0, _) in zip(times, times[1:]))
    assert dispatch.t0 <= times[0][0] and times[-1][1] <= dispatch.t1
    syncs = [float(e["ts"]) for e in calls if e["name"] in SYNC_CALLS
             and root.t0 <= float(e["ts"]) <= root.t1]
    where = {c.stage: sum(c.t0 <= t <= c.t1 for t in syncs) for c in root.children}
    assert where["prep"] == 2 and where["wait"] == 2 and len(syncs) == 4, where


@pytest.mark.cuda
@pytest.mark.parametrize("cond", [False, True])
def test_card_search_syncs_lie_in_prep_and_wait(cond, tmp_path):
    """On the card the flat search's four host syncs are the two copies up
    (prep) and the two copies down (wait)."""
    db, x = _open("flat", "cuda")
    try:
        kw = {"condition": QueryCondition().where("n", ">=", 300)} if cond else {}
        searches = [{"q": x[400 + i], "top_k": 10, **kw} for i in range(3)]
        roots, calls = _trace(db, tmp_path, searches)
    finally:
        db.close()
    syncs = [float(e["ts"]) for e in calls if e["name"] in SYNC_CALLS]
    assert len(roots) == 3
    for root in roots:
        inside = [t for t in syncs if root.t0 <= t <= root.t1]
        where = {c.stage: sum(c.t0 <= t <= c.t1 for t in inside) for c in root.children}
        assert where["prep"] == 2 and where["wait"] == 2, where
        assert len(inside) == 4, where
