"""The program's spans in a synthetic traced window: `vdbbench.spans` and
the seven span readers."""

import pytest
from conftest import BENCH
from test_vdbb_layers import ev, synthetic

from vdbbench import harness, spans, traceread

READERS = {"capture_ms.search": "capture", "mask_ms.search": "mask",
           "prep_ms.search": "prep", "dispatch_ms.search": "dispatch",
           "wait_ms.search": "wait", "results_ms.search": "results",
           "post_ms.search": "post"}


def ua(name, ts, dur, tid=1):
    return {**ev("user_annotation", "tostore." + name, ts, dur), "tid": tid}


def searches():
    """A 1,000 us window: two searches of 400 us at 0 and 500, each with its
    seven stages (the mask inside the capture, the bias inside the
    dispatch), a 100 us kernel in the first one's wait and a 50 us copy in
    the second's; a stream synchronise in each prep and two in each wait;
    the device-side copy of a span (ignored); a `tostore.insert` on another
    thread from 950 to 1,000."""
    e = [ev("user_annotation", traceread.WINDOW, 0.0, 1000.0)]
    for t in (0.0, 500.0):
        s = "vector_search."
        e += [ua("vector_search", t, 400), ua(s + "capture", t + 10, 40),
              ua(s + "mask", t + 20, 20), ua(s + "prep", t + 50, 50), ua(s + "dispatch", t + 100, 100),
              ua(s + "bias", t + 110, 30), ua(s + "wait", t + 200, 120),
              ua(s + "results", t + 320, 50), ua(s + "post", t + 370, 20),
              ev("cuda_runtime", "cudaStreamSynchronize", t + 60, 5),
              ev("cuda_runtime", "cudaStreamSynchronize", t + 210, 50),
              ev("cuda_runtime", "cudaStreamSynchronize", t + 300, 5),
              ev("cuda_runtime", "cudaLaunchKernel", t + 150, 5),
              ev("gpu_user_annotation", "tostore.vector_search.wait", t + 220, 100)]
    e += [ev("kernel", "lane_scan", 220.0, 100.0), ev("gpu_memcpy", "Memcpy DtoH", 720.0, 50.0),
          ua("insert", 950.0, 50.0, tid=2)]
    return traceread.Trace(e)


class Win:
    queries = 2
    lat = []


def ctx(trace):
    return harness.Context(trace=trace, window=Win(), config={}, traffic={"batch": 1},
                           timings={})


@pytest.mark.parametrize("metric,stage", READERS.items())
def test_reader_reads_its_span(metric, stage):
    want = {"capture": 40, "mask": 20, "prep": 50, "dispatch": 100, "wait": 120,
            "results": 50, "post": 20}[stage]
    read = harness.reader("layers", metric, BENCH)
    assert read(ctx(searches())) == pytest.approx(want / 1e3)  # 2 x us over 2 queries, in ms


@pytest.mark.parametrize("metric", READERS)
def test_reader_returns_none_without_its_span(metric):
    read = harness.reader("layers", metric, BENCH)
    assert read(ctx(synthetic())) is None  # a trace of a program without spans
    assert read(ctx(traceread.Trace([ev("user_annotation", traceread.WINDOW, 0.0, 9.0)]))) is None


def test_device_side_annotations_are_not_read():
    tr = searches()
    assert spans.span_ms(tr, "vector_search.wait") == pytest.approx(0.24)  # 2 x 120 us
    assert spans.span_ms(tr, "vector_search.absent") is None


def test_table_parts_sum_to_the_window():
    tr = searches()
    table = spans.span_table(tr, 2)
    idle_s = tr.window_s - tr.busy_s()
    assert sum(r["idle_ms"] for r in table.values()) * 2 / 1e3 == pytest.approx(idle_s, abs=1e-6)
    assert sum(r["self_ms"] for r in table.values()) * 2 / 1e3 == pytest.approx(tr.window_s,
                                                                                abs=1e-6)
    assert list(table)[-1] == spans.OUTSIDE


def test_table_rows():
    t = spans.span_table(searches(), 2)
    root = t["vector_search"]
    assert root["ms"] == pytest.approx(0.4)
    assert root["self_ms"] == pytest.approx(0.4 - 0.04 - 0.05 - 0.1 - 0.12 - 0.05 - 0.02)
    assert t["vector_search.capture"]["self_ms"] == pytest.approx(0.02)  # 40 less the mask's 20
    assert t["vector_search.dispatch"]["self_ms"] == pytest.approx(0.07)
    # idle: the wait of the first search is busy 220-320 (100 of its 120 us);
    # the second's wait (700-820) is busy 720-770 (50 us)
    assert t["vector_search.wait"]["idle_ms"] == pytest.approx((20 + 70) / 2 / 1e3)
    assert t["vector_search.prep"]["idle_ms"] == pytest.approx(0.05)
    # outside: 400-500 and 900-950 (the first search opens at 0, the insert at 950)
    assert t["outside"]["self_ms"] == pytest.approx((100 + 50) / 2 / 1e3)
    assert t["insert"]["self_ms"] == pytest.approx(0.025)


def test_syncs_land_in_the_span_they_start_in():
    t = spans.span_table(searches(), 2)
    assert t["vector_search.prep"]["syncs"] == 1
    assert t["vector_search.wait"]["syncs"] == 2
    assert sum(r["syncs"] for r in t.values()) == 3


def test_overlapping_threads_go_to_the_span_opened_last():
    tr = traceread.Trace([ev("user_annotation", traceread.WINDOW, 0.0, 100.0),
                          ua("a", 0, 80, tid=1), ua("b", 20, 80, tid=2),
                          ev("cuda_runtime", "cudaStreamSynchronize", 30, 1)])
    t = spans.span_table(tr, 1)
    assert t["a"]["self_ms"] == pytest.approx(0.02) and t["a"]["ms"] == pytest.approx(0.08)
    assert t["b"]["self_ms"] == pytest.approx(0.08) and t["b"]["syncs"] == 1
    assert t["outside"]["self_ms"] == pytest.approx(0.0)


def test_program_without_spans_has_only_outside():
    tr = synthetic()
    t = spans.span_table(tr, 2)
    assert list(t) == [spans.OUTSIDE]
    assert t[spans.OUTSIDE]["idle_ms"] * 2 / 1e3 == pytest.approx(750e-6)
    assert t[spans.OUTSIDE]["syncs"] == 1.0  # 2 synchronises over 2 queries


def test_idle_gaps_unchanged_by_the_spans():
    """`idle_gaps` labels by operators and CUDA calls: the spans move none
    of its labels (the trace of test_vdbb_layers reads as before)."""
    gaps = dict(synthetic().idle_gaps())
    assert gaps["aten::sort"] == pytest.approx(330e-6)
    assert sum(gaps.values()) == pytest.approx(750e-6)
    labels = {n for n, _ in searches().idle_gaps()}
    assert not any(n.startswith("tostore.") for n in labels)
