"""Tiny CPU runs of the cells for the tests: the real widths (768), a few
thousand rows, a short window."""

import json

from conftest import BENCH, ROOT

from vdbbench import harness

SMALL = {"rows": 16384, "load_chunk": 4096,
         "data": {"generator": "clustered", "modes": 16, "centre_scale": 3.0, "noise": 1.0}}
IVF_SMALL = {"num_clusters": 16, "nprobe": 4}
TRAFFIC = {"pool": 512, "warmup_requests": 2, "check_sample": 32, "trace_seconds": 0.5}

# The IVF cell, which BENCHMARK.json leaves out while its host-bound rate
# and tail spread past any bound between processes (PERF.md): its
# configuration file and the harness's IVF path stay, tested from a
# checkout whose BENCHMARK.json adds it back.
IVF_CELL = "cohere768-1m-ivf.serial"
IVF_CONFIG = {"name": "cohere768-1m-ivf", "source": "VectorDBBench Performance768D1M on IVF_FLAT",
              "file": "benchmark/configs/cohere768-1m-ivf.json", "reduced": [],
              "why": "IVF raw, nlist 1024 / nprobe 16, trained by the engine's maintenance"}


def ivf_root(tmp_path):
    """A checkout of BENCHMARK.json with the IVF cell added, every metric
    that lists its cells listing it too, beside the benchmark's folder."""
    spec = harness.load_spec(ROOT)
    spec["configs"].append(IVF_CONFIG)
    spec["workloads"].append({"name": IVF_CELL, "config": IVF_CONFIG["name"],
                              "traffic": "serial", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(IVF_CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / BENCH.name).symlink_to(BENCH)
    return tmp_path


def root_of(cell, tmp_path):
    return ivf_root(tmp_path) if cell == IVF_CELL else ROOT


def run(cell, seed=2**31 + 11, seconds=0.5, trace=False, root=ROOT, config=None,
        monkeypatch=None, **kw):
    patch = dict(SMALL)
    if "ivf" in cell:
        import tostore_tpu_torch.engine.crontab as crontab

        monkeypatch.setattr(crontab, "VECTOR_MAINT_EVERY_S", 0.2)
        patch["index"] = {"index_type": "ivf", **IVF_SMALL}
    patch.update(config or {})
    traffic = TRAFFIC
    return harness.run_cell(cell, seed, seconds, trace, device="cpu", root=root,
                            config_patch=patch, traffic_patch=dict(traffic), **kw)
