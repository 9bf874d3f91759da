"""The IVF cell's four readers on built traces: the probe's three spans
inside `dispatch`, and K3's share of its roofline."""

import json

import pytest
from conftest import BENCH, ROOT
from test_vdbb_layers import ev, synthetic
from test_vdbb_spans import ua

from vdbbench import harness, k3roofline, traceread

SPANS = {"probes_ms.search": "probes", "scan_ms.search": "scan", "select_ms.search": "select"}
IVF = json.loads((BENCH / "configs" / "cohere768-1m-ivf.json").read_text())


def probe_searches():
    """A 1,000 us window: two IVF searches at 0 and 500, each a dispatch of
    100 us holding probes (10 us), scan (40) and select (30); in each scan
    the pre-pass (5 us) and K3 (20 us) on the device, and a select_topk
    (4 us) that is no K3 kernel."""
    e = [ev("user_annotation", traceread.WINDOW, 0.0, 1000.0)]
    for t in (0.0, 500.0):
        s = "vector_search."
        e += [ua("vector_search", t, 400), ua(s + "prep", t + 10, 40),
              ua(s + "dispatch", t + 100, 100), ua(s + "probes", t + 105, 10),
              ua(s + "scan", t + 120, 40), ua(s + "select", t + 165, 30),
              ua(s + "wait", t + 200, 100),
              ev("kernel", "void (anonymous namespace)::ivf_group_kernel(void const*, int)",
                 t + 130, 5),
              ev("kernel", "void (anonymous namespace)::ivf_probe_wgmma_kernel<16>(CUtensorMap)",
                 t + 136, 20),
              ev("kernel", "void (anonymous namespace)::select_topk_kernel<128, true, float>()",
                 t + 170, 4)]
    return traceread.Trace(e)


class Win:
    queries = 2
    lat = []


def ctx(trace, config=IVF):
    return harness.Context(trace=trace, window=Win(), config=config, traffic={"batch": 1},
                           timings={})


def read(name):
    return harness.reader("layers", name, BENCH)


@pytest.mark.parametrize("metric,stage", SPANS.items())
def test_reader_reads_its_span(metric, stage):
    want = {"probes": 10, "scan": 40, "select": 30}[stage]
    assert read(metric)(ctx(probe_searches())) == pytest.approx(want / 1e3)


@pytest.mark.parametrize("metric", [*SPANS, "k3_roofline_pct.search"])
def test_reader_returns_none_without_its_span_or_kernels(metric):
    assert read(metric)(ctx(synthetic())) is None  # a flat window: no probe spans, no K3
    assert read(metric)(ctx(traceread.Trace([ev("user_annotation", traceread.WINDOW, 0.0,
                                                 9.0)]))) is None


def test_k3_roofline_by_hand():
    # 16 x 1,000,000 / 1,024 rows of 768 bf16 values and an f32 bias, and a
    # bf16 query, over 2 x 25 us of K3 and its pre-pass
    nbytes = 16 * 1_000_000 / 1024 * (768 * 2 + 4) + 768 * 2
    assert k3roofline.bytes_per_query(IVF) == pytest.approx(nbytes)
    assert k3roofline.kernel_s(probe_searches()) == pytest.approx(50e-6)
    want = 100.0 * (nbytes / 3.35e12) * 2 / 50e-6
    assert read("k3_roofline_pct.search")(ctx(probe_searches())) == pytest.approx(want)


def test_k3_roofline_has_no_count_for_flat_or_pq():
    flat = json.loads((BENCH / "configs" / "cohere768-1m-flat.json").read_text())
    pq = {**IVF, "index": {**IVF["index"], "pq_subspaces": 96}}
    for config in (flat, pq):
        assert k3roofline.bytes_per_query(config) is None
        assert read("k3_roofline_pct.search")(ctx(probe_searches(), config)) is None


def test_the_ivf_cell_reads_its_four_metrics():
    spec = harness.load_spec(ROOT)
    names = {m["name"] for m in harness.metrics_for(spec, "cohere768-1m-ivf.serial", True)}
    assert {*SPANS, "k3_roofline_pct.search"} <= names
    assert "mask_ms.search" not in names
    for cell in ("cohere768-1m-flat.serial", "cohere768-1m-flat.filter1pct"):
        flat = {m["name"] for m in harness.metrics_for(spec, cell, True)}
        assert not flat & {*SPANS, "k3_roofline_pct.search"}
