"""The float32 flat cell: the schema's default field type under the default
flat index. On the CPU at a tiny size, the search takes K1's route (its
plain version) and comes out correct, the same run with the rows stored in
bfloat16 does not, and K1's roofline is counted by hand. On the card, at
the cell's own size, the bf16 control is never correct and the window
replays the f32 K1 graph on every search."""

import json

import pytest
import torch
from conftest import BENCH, ROOT
from runs import run
from test_vdbb_layers import ev

from vdbbench import harness, k1roofline, traceread

CELL = "cohere768-1m-f32-flat.serial"
F32 = json.loads((BENCH / "configs" / "cohere768-1m-f32-flat.json").read_text())
BF16 = json.loads((BENCH / "configs" / "cohere768-1m-flat.json").read_text())
# the K1 instances and their neighbours as the profiler names them
K1_F32 = "void (anonymous namespace)::lane_topk_kernel<float, 8, 16, false>(float const*)"
K1_BF16 = "void lane_scan::lane_scan_kernel<false, 8, 16>(CUtensorMap_st, CUtensorMap_st)"
NOT_K1 = ("void (anonymous namespace)::lane_topk_kernel<float, 32, 0, false>(float const*)",
          "void (anonymous namespace)::lane_topk_kernel<float, 32, 0, true>(float const*)",
          "void lane_scan::lane_scan_kernel<false, 64, 0>(CUtensorMap_st, CUtensorMap_st)",
          "void (anonymous namespace)::select_topk_kernel<128, true, float>()")


@pytest.fixture
def k1_route(monkeypatch):
    """Auto's fused route from 4,096 slots, so that the tiny table's single
    queries take K1 (its plain version here) and not the exact scan; the
    plain K1's calls are counted."""
    from tostore_tpu_torch.ops import topk

    monkeypatch.setattr(topk, "MIN_FUSED_N", 4096)
    calls = []
    real = topk._fused_flat_topk_plain

    def counted(q, corpus, *a, **kw):
        calls.append(corpus.dtype)
        return real(q, corpus, *a, **kw)

    monkeypatch.setattr(topk, "_fused_flat_topk_plain", counted)
    return calls


def test_the_config_is_the_bf16_flat_cell_in_float32():
    assert F32["precision"] == "float32" and F32["index"] == {"index_type": "flat"}
    same = ("rows", "dims", "metric", "top_k", "load_chunk", "data", "table", "key_field",
            "vector_field")
    assert {k: F32[k] for k in same} == {k: BF16[k] for k in same}
    assert F32["check"]["candidate_rule"] == BF16["check"]["candidate_rule"]
    assert F32["check"]["limits"]["bad"] == 0


def test_sound_run_takes_k1_and_is_correct(k1_route):
    got = run(CELL)
    assert got["correct"], got["checks"]
    assert got["failed"] == 0 and got["attempted"] > 0
    assert set(got["checks"]) == {"dist_err", "gap", "bad"}
    # every search of the window (and of the set-up) scanned the f32 rows on K1
    assert len(k1_route) >= got["attempted"] and set(k1_route) == {torch.float32}


def test_rows_stored_in_bf16_are_not_correct(k1_route):
    """The nearest stored type below float32 fails the cell's limits."""
    got = run(CELL, program_patch={"precision": "bfloat16"})
    assert not got["correct"]
    assert got["checks"]["dist_err"]["value"] > got["checks"]["dist_err"]["limit"]
    assert set(k1_route) == {torch.bfloat16}


def window(*kernels):
    """A 1,000 us window of two searches, each running `kernels` for 20 us."""
    e = [ev("user_annotation", traceread.WINDOW, 0.0, 1000.0)]
    for t in (0.0, 500.0):
        e += [ev("kernel", name, t + 10 + 30 * i, 20) for i, name in enumerate(kernels)]
    return traceread.Trace(e)


class Win:
    queries = 2


def k1_pct(trace, config):
    ctx = harness.Context(trace=trace, window=Win(), config=config, traffic={"batch": 1})
    return harness.reader("layers", "k1_roofline_pct.search", BENCH)(ctx)


@pytest.mark.parametrize("config,elem,k1", [(F32, 4, K1_F32), (BF16, 2, K1_BF16)],
                         ids=["float32", "bfloat16"])
def test_k1_roofline_by_hand(config, elem, k1):
    # 1,000,000 rows of 768 values, a bf16 query and 100 hits of 8 B, over
    # 2 x 20 us of K1; the other kernels of the window are not K1
    nbytes = 1_000_000 * 768 * elem + 768 * 2 + 100 * 8
    assert k1roofline.least_ms_per_query(config, 1) == pytest.approx(nbytes / 3.35e12 * 1e3)
    trace = window(k1, *NOT_K1)
    assert k1roofline.kernel_s(trace) == pytest.approx(40e-6)
    assert k1_pct(trace, config) == pytest.approx(100.0 * nbytes / 3.35e12 * 2 / 40e-6)


def test_k1_roofline_finds_nothing_without_k1_or_a_flat_index():
    assert k1_pct(window(*NOT_K1), F32) is None
    ivf = json.loads((BENCH / "configs" / "cohere768-1m-ivf.json").read_text())
    assert k1roofline.least_ms_per_query(ivf, 1) is None
    assert k1_pct(window(K1_F32), ivf) is None
    assert not any(k1roofline.is_k1(name) for name in NOT_K1)


def test_the_cell_reads_the_flat_metrics_and_k1_roofline():
    spec = harness.load_spec(ROOT)
    names = {m["name"] for m in harness.metrics_for(spec, CELL, True)}
    flat = {m["name"] for m in harness.metrics_for(spec, "cohere768-1m-flat.serial", True)}
    assert names == flat | {"k1_roofline_pct.search"}
    assert "k1_roofline_pct.search" not in flat


@pytest.mark.cuda
def test_bf16_control_at_the_cells_size_on_the_card(card):
    """The rows stored in bfloat16 at the cell's own size, on three seeds:
    never correct."""
    for seed in (2**31 + 301, 2**31 + 302, 2**31 + 303):
        got = harness.run_cell(CELL, seed, 2.0, False, device=card,
                               program_patch={"precision": "bfloat16"})
        assert not got["correct"], (seed, got["checks"])
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_the_window_replays_the_f32_k1_graph_on_every_search(card, monkeypatch):
    """One run of the cell: every search of the window is one replay of the
    flat graph around K1 f32, no bf16 K1 runs, and every answer is
    correct."""
    from tostore_tpu_torch.ops import topk

    seen = {}
    real = harness.Window.run

    def counted(self, seconds):  # the measured window, not the probe after it
        before = dict(topk.LAUNCHES)
        real(self, seconds)
        if not seen:
            seen.update({k: topk.LAUNCHES[k] - before[k] for k in before})

    monkeypatch.setattr(harness.Window, "run", counted)
    got = harness.run_cell(CELL, 2**31 + 311, 5.0, False, device=card)
    assert got["correct"] and got["failed"] == 0, got["checks"]
    n = got["attempted"]
    assert n > 0
    assert seen["flat_graph"] == n and seen["lane_topk_acc_f32"] == n, seen
    assert seen["lane_topk_acc"] == 0 and seen["flat_graph_capture"] == 0, seen
    torch.cuda.empty_cache()
