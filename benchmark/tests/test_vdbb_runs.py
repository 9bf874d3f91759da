"""Whole runs at a tiny size on the CPU (the harness's look for a card
skipped): sound runs are correct, and the control and each fault that a
cell can have under its timed path make `correct` false."""

import pytest
import torch
from runs import IVF_CELL, IVF_SMALL, SMALL, ivf_root, root_of, run

CELLS = ["cohere768-1m-flat.serial", IVF_CELL, "cohere768-1m-flat.filter1pct"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, monkeypatch, tmp_path):
    got = run(cell, root=root_of(cell, tmp_path), monkeypatch=monkeypatch)
    assert got["correct"], got["checks"]
    assert got["failed"] == 0 and got["attempted"] > 0
    assert "setup_s" in got["metrics"] and len(got["metrics"]) >= 2
    assert list(got)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_is_correct_and_reads_the_trace(cell, monkeypatch, tmp_path):
    got = run(cell, trace=True, root=root_of(cell, tmp_path), monkeypatch=monkeypatch)
    assert got["correct"], got["checks"]
    assert got["device"]["window_s"] > 0 and "breakdown" in got
    assert any(name.startswith("aten_ops_per_query") for name in got["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_int8_is_not_correct(cell, monkeypatch, tmp_path):
    """The program's own int8 field path, the type below bfloat16."""
    got = run(cell, root=root_of(cell, tmp_path), program_patch={"precision": "int8"},
              monkeypatch=monkeypatch)
    assert not got["correct"]
    assert got["checks"]["dist_err"]["value"] > got["checks"]["dist_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced_is_not_correct(cell, monkeypatch, tmp_path):
    """One hit's slot moved to another row in the index's finalize step."""
    from tostore_tpu_torch.ops import distance

    real = distance.finalize_results

    def altered(metric, scores, slots, qsq):
        d, s = real(metric, scores, slots, qsq)
        s = s.clone()
        s[:, -1] = (s[:, -1] + 7) % 4096
        return d, s

    for mod in ("tostore_tpu_torch.vector.flat", "tostore_tpu_torch.vector.ivf"):
        monkeypatch.setattr(f"{mod}.D.finalize_results", altered)
    got = run(cell, root=root_of(cell, tmp_path), monkeypatch=monkeypatch)
    assert not got["correct"] and got["failed"] > 0


def test_fewer_clusters_probed_is_not_correct(monkeypatch, tmp_path):
    """The IVF index probes 1 cluster where the configuration says 4 (at
    this size): hits of the exact top k are lost, and `miss` reads over
    its limit."""
    got = run(IVF_CELL, root=ivf_root(tmp_path), monkeypatch=monkeypatch,
              program_patch={"index": {"index_type": "ivf", **IVF_SMALL, "nprobe": 1}})
    assert not got["correct"]
    assert got["checks"]["miss"]["value"] > got["checks"]["miss"]["limit"]


def test_ivf_set_up_fails_on_an_untrained_index(monkeypatch, tmp_path):
    """Where the engine's maintenance trains nothing, set-up fails rather
    than measure the exact fallback that an untrained index serves."""
    from tostore_tpu_torch.engine.database import Database

    monkeypatch.setattr(Database, "run_vector_maintenance", lambda self, *a, **kw: 0)
    with pytest.raises(RuntimeError, match="did not train"):
        run(IVF_CELL, root=ivf_root(tmp_path), monkeypatch=monkeypatch,
            config={"train_wait_s": 0.5})


def test_ivf_window_runs_on_the_trained_index(monkeypatch, tmp_path):
    """The IVF cell's searches take the probe path, not the flat fallback."""
    from tostore_tpu_torch.vector import ivf

    probes = []
    real = ivf.bucket_probe_scores

    def counted(*a, **kw):
        probes.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ivf, "bucket_probe_scores", counted)
    got = run(IVF_CELL, root=ivf_root(tmp_path), monkeypatch=monkeypatch)
    assert got["correct"] and got["attempted"] > 0
    assert len(probes) >= got["attempted"]


@pytest.mark.parametrize("flush_every_s", [0.001, 1000.0])
def test_engine_load_reaches_the_index_batch_by_batch(flush_every_s, monkeypatch):
    """Whatever the engine's background flush does meanwhile, each batch of
    the load reaches the index alone, so the corpus ends at the capacity
    of per-batch upserts (which a flat scan reads whole)."""
    import tostore_tpu_torch.engine.crontab as crontab
    from conftest import ROOT
    from tostore_tpu_torch.vector.corpus import DeviceCorpus

    from vdbbench import datagen, harness, system

    monkeypatch.setattr(crontab, "VECTOR_FLUSH_EVERY_S", flush_every_s)
    spec = harness.load_spec(ROOT)
    config = {**harness.config_of(spec, ROOT, "cohere768-1m-flat"), **SMALL}
    sut = system.EngineTable(config, "cpu")
    try:
        sut.load(datagen.Mixture(config["data"], config["dims"], 5, "cpu").rows(config["rows"]))
        got = sut.state()
    finally:
        sut.close()
    cap, step = 0, config["load_chunk"]
    for start in range(0, config["rows"], step):
        m = min(step, config["rows"] - start)
        for need in (start + m, start + (1 << (m - 1).bit_length())):
            if need > cap:
                cap = DeviceCorpus.canonical_cap(max(need, 2 * cap) if cap else need)
    assert got["rows"] == config["rows"] and got["capacity"] == cap


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size_on_the_card(cell, card, tmp_path):
    """The control at the cell's own size, on three seeds: never correct."""
    from vdbbench import harness

    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        got = harness.run_cell(cell, seed, 2.0, False, device=card, root=root_of(cell, tmp_path),
                               program_patch={"precision": "int8"})
        assert not got["correct"], (seed, got["checks"])
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_one_cluster_probed_at_the_cells_size_on_the_card(card, tmp_path):
    """nprobe 1 in place of 16 at the IVF cell's own size, on three seeds:
    never correct (`miss` over its limit)."""
    from vdbbench import harness

    root = ivf_root(tmp_path)
    index = harness.config_of(harness.load_spec(root), root, "cohere768-1m-ivf")["index"]
    for seed in (2**31 + 201, 2**31 + 202, 2**31 + 203):
        got = harness.run_cell(IVF_CELL, seed, 2.0, False, device=card, root=root,
                               program_patch={"index": {**index, "nprobe": 1}})
        assert not got["correct"], (seed, got["checks"])
        assert got["checks"]["miss"]["value"] > got["checks"]["miss"]["limit"]
    torch.cuda.empty_cache()
