"""A later change adds a configuration, a traffic mix, a cell and metrics
as files and entries only: in a copy of the benchmark, the harness finds
and runs them."""

import json
import shutil

from conftest import BENCH, ROOT
from runs import run

from vdbbench import harness


def test_new_config_cell_and_metrics_as_files_only(tmp_path, monkeypatch):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())

    cfg = json.loads((bench / "configs" / "cohere768-1m-flat.json").read_text())
    cfg.update(name="dummy-flat-dot", metric="innerProduct")
    cfg["check"]["limits"]["dist_err"] = 1e-2  # scores of norm ~80 rows: f32 sums of ~6,400
    (bench / "configs" / "dummy-flat-dot.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "serial.json").read_text())
    traffic.update(clients=2, why="two clients in a closed loop")
    (bench / "traffic" / "c2.json").write_text(json.dumps(traffic))
    (bench / "e2e" / "search_p50_ms.py").write_text(
        "import numpy as np\n\ndef read(ctx):\n    return float(np.median(ctx.window.lat) * 1e3)\n")
    (bench / "layers" / "requests_per_s.search.py").write_text(
        "def read(ctx):\n    return ctx.window.requests / ctx.trace.window_s\n")

    spec["configs"].append({"name": "dummy-flat-dot", "source": "a test",
                            "file": "benchmark/configs/dummy-flat-dot.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "dummy-flat-dot.c2", "config": "dummy-flat-dot",
                              "traffic": "c2", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "search_p50_ms", "unit": "ms", "better": "lower",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["dummy-flat-dot.c2"]})
    spec["per_layer"].append({"name": "requests_per_s.search", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "engine", "moves": "search_p50_ms",
                              "workloads": ["dummy-flat-dot.c2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    got = run("dummy-flat-dot.c2", root=tmp_path, monkeypatch=monkeypatch)
    assert got["correct"], got["checks"]
    assert set(got["metrics"]) == {"setup_s", "search_p50_ms"}
    got = run("dummy-flat-dot.c2", root=tmp_path, trace=True, monkeypatch=monkeypatch)
    assert set(got["metrics"]) == {"requests_per_s.search"}
    assert got["correct"], got["checks"]
    # the cells already there are untouched by the additions
    assert harness.metrics_for(spec, "cohere768-1m-flat.serial", False) == \
        harness.metrics_for(harness.load_spec(ROOT), "cohere768-1m-flat.serial", False)
