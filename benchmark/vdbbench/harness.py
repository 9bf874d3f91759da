"""One run of one cell: set-up, the measured (or traced) window, the
metrics and the comparison with the reference.

Everything that belongs to one configuration, traffic mix or metric is a
file found by name under the benchmark's folder:
  - `configs/<config>.json`: the deployment (the `file` of BENCHMARK.json);
  - `traffic/<cell>.json`, else `traffic/<traffic>.json`: the traffic mix;
  - `e2e/<metric>.py` and `layers/<metric>.py`, else the file of the
    metric's name up to its first dot (one reader for `x.search` and
    `x.batch`): a `read(ctx)` that returns a number, or None where the run
    has nothing to read.
"""

from __future__ import annotations

import gc
import heapq
import importlib.util
import itertools
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from . import datagen, reference, system, traceread

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tostore_tpu"})  # by whole top-level name


# ----------------------------------------------------------------------------- the spec

def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(spec: dict, root: Path, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_of(cell: dict, bench: Path = HERE) -> dict:
    for stem in (cell["name"], cell["traffic"]):
        path = bench / "traffic" / f"{stem}.json"
        if path.exists():
            with open(path) as f:
                return json.load(f)
    raise FileNotFoundError(f"no traffic file for {cell['name']!r} under {bench / 'traffic'}")


def reader(kind: str, name: str, bench: Path = HERE):
    """The `read` function of a metric's reader file."""
    for stem in (name, name.split(".")[0]):
        path = bench / kind / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"vdbbench_{kind}_{stem.replace('.', '_').replace('-', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for {kind} metric {name!r} under {bench / kind}")


def metrics_for(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    if not trace:
        return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in metrics_for(spec, cell, False)}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


# ----------------------------------------------------------------------------- the window

class Window:
    """A closed loop: each client sends its next request when the last one
    has returned, until `seconds` have passed since the start. Requests take
    queries from the pool in order (wrapping past its end). The window ends
    when the last request returns, so the rates count all the work and all
    the time. A sample of the answers, drawn from the seed by priority, is
    kept for the comparison."""

    def __init__(self, search, pool: np.ndarray, traffic: dict, seed: int):
        self.search, self.pool = search, pool
        self.batch = int(traffic["batch"])
        self.clients = int(traffic["clients"])
        self.keep = int(traffic["check_sample"])
        self.calls = len(pool) // self.batch
        prio = np.random.default_rng(datagen.stream_seed(seed, "sample")).random(1 << 20)
        self.prio = prio.tolist()
        self.lat, self.failed, self.errors = [], 0, []
        self.sample: list = []  # heap of (-priority, request, result)
        self._next = itertools.count()
        self._lock = threading.Lock()

    def query(self, r: int) -> np.ndarray:
        j = r % self.calls
        return self.pool[j] if self.batch == 1 else self.pool[j * self.batch:(j + 1) * self.batch]

    def _client(self, deadline: float, lat: list):
        while True:
            r = next(self._next)
            q = self.query(r)
            t0 = time.perf_counter()
            if t0 >= deadline:
                return
            try:
                res = self.search(q)
            except Exception as exc:  # counted as failed; the run reports incorrect
                res = None
                with self._lock:
                    self.failed += 1
                    self.errors.append(repr(exc))
            lat.append(time.perf_counter() - t0)
            if res is None or not self.keep:
                continue
            p = -self.prio[r & ((1 << 20) - 1)]
            with self._lock:
                if len(self.sample) < self.keep:
                    heapq.heappush(self.sample, (p, r, res))
                elif p > self.sample[0][0]:
                    heapq.heapreplace(self.sample, (p, r, res))

    def run(self, seconds: float):
        lats = [[] for _ in range(self.clients)]
        self.t0 = time.perf_counter()
        deadline = self.t0 + seconds
        if self.clients == 1:
            self._client(deadline, lats[0])
        else:
            threads = [threading.Thread(target=self._client, args=(deadline, lat))
                       for lat in lats]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        self.t1 = time.perf_counter()
        self.lat = [x for lat in lats for x in lat]

    @property
    def elapsed_s(self) -> float:
        return self.t1 - self.t0

    @property
    def requests(self) -> int:
        return len(self.lat)

    @property
    def queries(self) -> int:
        return len(self.lat) * self.batch

    def profile(self) -> dict:
        """For the run's earlier lines: requests started in each second of
        the window, the median and the longest request (ms)."""
        if not self.lat:
            return {}
        starts = np.cumsum([0.0] + self.lat[:-1]) if self.clients == 1 else None
        per_s = (np.bincount(starts.astype(int)).tolist() if starts is not None else [])
        return {"per_second": per_s, "p50_ms": float(np.median(self.lat) * 1e3),
                "max_ms": float(max(self.lat) * 1e3)}

    def sampled(self):
        """[(request, result)] of the kept answers, by request."""
        return sorted((r, res) for _, r, res in self.sample)


class Context:
    """What a metric's reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _timings_delta(before: dict, after: dict) -> dict:
    out = {}
    for op, a in after.items():
        b = before.get(op, {"count": 0, "total_ms": 0.0})
        if a["count"] > b["count"]:
            out[op] = {"count": a["count"] - b["count"], "total_ms": a["total_ms"] - b["total_ms"]}
    return out


def _traced(win: Window, seconds: float, cuda: bool):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(traceread.WINDOW):
            win.run(seconds)
        if cuda:
            torch.cuda.synchronize()
    tmp = Path(os.environ.get("TMPDIR") or "/tmp")
    path = tmp / f"vdbbench_trace_{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    try:
        return traceread.Trace(traceread.load(path))
    finally:
        path.unlink()


def _device_probe(search, warm: np.ndarray, traffic: dict, seed: int) -> dict:
    """After the window, for a run's earlier lines: the device time a
    request of the warm-up queries spends in each of its three longest
    device operations (us), from a 0.25-s traced window. No metric reads
    it."""
    probe = Window(search, warm, {**traffic, "clients": 1, "check_sample": 0}, seed)
    try:
        tr = _traced(probe, 0.25, True)
    except Exception as exc:  # a diagnostic only: the run goes on without it
        return {"error": repr(exc)}
    n = max(1, probe.requests)
    return {"requests": probe.requests,
            "device_us": {name[:80]: sec * 1e6 / n for name, sec in tr.device_ops(3)}}


# ----------------------------------------------------------------------------- a run

def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path | None = None, t_start: float | None = None, config_patch=None,
             traffic_patch=None, program_patch=None) -> dict:
    """One run; returns the result (its last line) and the compared numbers.
    `config_patch` / `traffic_patch` update the files' dicts for both sides
    (tests run tiny sizes); `program_patch` updates only the configuration
    the program is built from (the control: its int8 path)."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(root) if root else HERE.parent
    bench = root / HERE.name
    spec = load_spec(root)
    cell = cell_of(spec, workload)
    config = config_of(spec, root, cell["config"])
    config.update(config_patch or {})
    traffic = traffic_of(cell, bench)
    traffic.update(traffic_patch or {})
    cuda = torch.device(device).type == "cuda"
    steps = {}

    def step(name, t0):
        steps[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    mix = datagen.Mixture(config["data"], config["dims"], seed, device)
    pool = mix.queries(int(traffic["pool"])).cpu().numpy()
    warm = mix.queries(int(traffic["warmup_requests"]) * int(traffic["batch"]),
                       "warmup").cpu().numpy()
    t = step("queries_s", t)
    sut = system.ENTRIES[traffic["entry"]]({**config, **(program_patch or {})}, device)
    t = step("open_s", t)
    sut.load(mix.rows(config["rows"]))
    if cuda:
        torch.cuda.synchronize()
    t = step("load_s", t)
    filt = traffic.get("filter")
    keep_from = 0
    if filt:
        keep_from = int(round(config["rows"] * (1.0 - float(filt["keep_share"]))))
        filt = {"field": filt["field"], "op": ">=", "value": keep_from}
    search = sut.searcher(sut.condition(filt))
    search(warm[: int(traffic["batch"])] if traffic["batch"] > 1 else warm[0])
    t = step("first_search_s", t)
    if config.get("train_wait_s"):
        try:
            steps["train_s"] = sut.wait_trained(float(config["train_wait_s"]))
        except RuntimeError:
            sut.close()
            raise
        t = time.perf_counter()
    b = int(traffic["batch"])
    for i in range(int(traffic["warmup_requests"])):
        search(warm[i * b:(i + 1) * b] if b > 1 else warm[i])
    if cuda:
        torch.cuda.synchronize()
    step("warmup_s", t)
    steps.update(system.launch_counts())
    setup_s = time.perf_counter() - t_start
    steps["setup_s"] = setup_s
    steps.update(sut.state())
    if cuda:
        steps["card"] = system.card_state()
    log("setup", json.dumps(steps))

    win = Window(search, pool, traffic, seed)
    before = sut.timings()
    gc0 = gc.get_stats()
    tr = None
    if trace:
        tr = _traced(win, min(seconds, float(traffic["trace_seconds"])), cuda)
    else:
        win.run(seconds)
    timings = _timings_delta(before, sut.timings())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log("window", json.dumps({"requests": win.requests, "queries": win.queries,
                              "seconds": win.elapsed_s, "failed": win.failed,
                              "errors": win.errors[:3], **win.profile(),
                              "gc_collections": [b["collections"] - a["collections"]
                                                 for a, b in zip(gc0, gc.get_stats())],
                              **system.launch_counts(),
                              **({"card": system.card_state()} if cuda else {})}))
    if cuda and not trace:
        log("probe", json.dumps(_device_probe(search, warm, traffic, seed)))

    ctx = Context(config=config, traffic=traffic, window=win, setup_s=setup_s, trace=tr,
                  timings=timings, cell=cell)
    metrics = {}
    for m in metrics_for(spec, workload, trace):
        v = reader("layers" if trace else "e2e", m["name"], bench)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the comparison, once the program is gone
    sample = win.sampled()
    results = [res for _, res in sample]
    answers = sut.answers(results) if results else None
    req = [r for r, _ in sample]
    sut.close()
    del sut, search, results, win.sample
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = {}
    wrong = 0
    if answers is not None:
        qs = [np.atleast_2d(win.query(r)) for r in req]
        of_row = np.concatenate([np.full(len(q), r) for q, r in zip(qs, req)])
        pks, dists, counts = answers
        t = time.perf_counter()
        verdict = reference.judge(config, mix, np.concatenate(qs), pks, dists, counts, keep_from)
        ref_s = time.perf_counter() - t
        limits = config["check"]["limits"]
        checks = {n: {"value": verdict["numbers"][n], "limit": limits[n]} for n in limits}
        wrong = len(set(of_row[verdict["wrong"]].tolist()))  # requests with a wrong answer
        log("check", json.dumps({"answers": len(pks), "recall_at_k": verdict["recall"],
                                 "reference_s": ref_s, **verdict["numbers"]}))
    correct = (answers is not None and win.failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {
        "correct": bool(correct),
        "attempted": win.requests,
        "failed": win.failed + wrong,
        "metrics": metrics,
        "device": device_block(device, peak),
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result


def device_block(device: str, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": 1,
            "memory_peak_bytes": int(peak)}
