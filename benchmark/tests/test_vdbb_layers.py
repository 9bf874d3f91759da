"""Each per-layer reader on a synthetic trace of a window."""

import pytest
from conftest import BENCH

from vdbbench import harness, traceread


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def synthetic():
    """A 1,000 us window: two searches, each 3 aten ops (one nested), a
    launch, a stream synchronise and a 100 us kernel; a memcpy of 50 us; a
    gap covered by a host op; an event outside the window."""
    e = [ev("user_annotation", traceread.WINDOW, 0.0, 1000.0)]
    for t in (0.0, 500.0):
        e += [ev("cpu_op", "aten::mm", t + 10, 50), ev("cpu_op", "aten::empty", t + 20, 5),
              ev("cpu_op", "aten::copy_", t + 100, 20), ev("cpu_op", "ProfilerStep", t, 1),
              ev("cuda_runtime", "cudaLaunchKernel", t + 30, 5),
              ev("cuda_runtime", "cudaStreamSynchronize", t + 110, 100),
              ev("kernel", "lane_topk_acc", t + 60, 100)]
    e += [ev("gpu_memcpy", "Memcpy DtoH", 180.0, 50.0), ev("cpu_op", "aten::sort", 300.0, 150.0),
          ev("kernel", "late", 2000.0, 10.0)]
    return traceread.Trace(e)


class Win:
    queries = 2
    lat = [i * 1e-3 for i in range(1, 101)]  # 1 ms to 100 ms


class NoWin:
    queries = 0
    lat = []


CFG = {"rows": 1_000_000, "dims": 768, "top_k": 100, "precision": "bfloat16",
       "index": {"index_type": "flat"}}


def ctx(**kw):
    base = dict(trace=synthetic(), window=Win(), config=CFG, traffic={"batch": 1},
                timings={"vector_search": {"count": 4, "total_ms": 6.0}})
    base.update(kw)
    return harness.Context(**base)


def read(name):
    return harness.reader("layers", name, BENCH)


def test_trace_window_and_device_time():
    tr = synthetic()
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s() == pytest.approx(250e-6)  # 60-160, 160-230 merged with the copy, 560-660
    assert tr.kernel_s() == pytest.approx(200e-6)
    assert tr.device_ops()[0] == ["lane_topk_acc", pytest.approx(200e-6)]
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::sort"] == pytest.approx(330e-6)  # 230-560 has its middle in aten::sort
    assert sum(gaps.values()) == pytest.approx(750e-6)


@pytest.mark.parametrize("name,want", [
    ("engine_ms.search", 1.5),
    ("aten_ops_per_query.search", 3.5),  # 7 aten:: events over 2 queries
    ("aten_ops_per_query.batch", 3.5),
    ("host_syncs_per_query.search", 1.0),
    ("kernels_per_query.batch", 1.0),
    ("device_idle_pct.search", 75.0),
    ("tail_p99_ms.search", 99.01),  # between 99 and 100 ms, linearly
])
def test_reader_on_synthetic_events(name, want):
    assert read(name)(ctx()) == pytest.approx(want)


def test_roofline_reader_counts_the_configuration_work():
    least = 1_000_000 * 768 * 2 + 768 * 2 + 800
    want = 100.0 * (least / 3.35e12) * 2 / 200e-6
    assert read("roofline_pct.search")(ctx()) == pytest.approx(want)


def test_readers_find_nothing_and_return_none():
    empty = traceread.Trace([ev("user_annotation", traceread.WINDOW, 0.0, 10.0)])
    c = ctx(trace=empty, timings={}, window=NoWin())
    for name in ("engine_ms.search", "aten_ops_per_query.search", "host_syncs_per_query.search",
                 "kernels_per_query.search", "roofline_pct.search", "device_idle_pct.search",
                 "tail_p99_ms.search"):
        assert read(name)(c) is None, name
