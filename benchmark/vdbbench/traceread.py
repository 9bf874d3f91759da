"""What a `torch.profiler` Chrome trace of the traced window holds.

The harness opens its own profiler around the window and marks the window
with `record_function(WINDOW)`; everything here reads the exported trace's
complete ("X") events: `cpu_op` (aten operators), `cuda_runtime` (the
host's CUDA calls), `kernel`, `gpu_memcpy` and `gpu_memset` (what ran on
the device), in microseconds on one clock.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

WINDOW = "bench_window"
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "cuda_runtime", "cuda_driver"})
# CUDA calls that block the host until the device has caught up. A copy
# down (`.cpu()`, `.item()`) is an asynchronous copy and the synchronise
# that completes it, so it counts once, by its synchronise; the blocking
# copy APIs count themselves.
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpyFromSymbol",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
})
HOST_SCAN = 512  # host events looked at, back from a gap, for what covers it


def load(path) -> list[dict]:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X"]


def _merge(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The complete events of one traced window."""

    def __init__(self, events: list[dict]):
        marks = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if len(marks) != 1:
            raise ValueError(f"expected one {WINDOW!r} annotation, found {len(marks)}")
        self.t0 = float(marks[0]["ts"])
        self.t1 = self.t0 + float(marks[0]["dur"])
        self.events = [e for e in events if self.t0 <= float(e.get("ts", -1)) <= self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def of(self, cats) -> list[dict]:
        return [e for e in self.events if e.get("cat") in cats]

    def count(self, cat: str, names=None, prefix: str | None = None) -> int:
        return sum(1 for e in self.events if e.get("cat") == cat
                   and (names is None or e["name"] in names)
                   and (prefix is None or e["name"].startswith(prefix)))

    def device_spans(self) -> list[list[float]]:
        """Merged [start, end] intervals (us) in which the device ran an
        operation, cut to the window."""
        return _merge((max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e["dur"]), self.t1))
                      for e in self.of(DEVICE_CATS))

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.device_spans()) / 1e6

    def kernel_s(self) -> float:
        return sum(float(e["dur"]) for e in self.of({"kernel"})) / 1e6

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: [name, seconds]."""
        tot = defaultdict(float)
        for e in self.of(DEVICE_CATS):
            tot[e["name"]] += float(e["dur"]) / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The device's idle time in the window, summed by what the host
        was doing in the middle of each gap: the innermost host event
        covering that moment, or "python" where no operator or CUDA call
        was running."""
        spans = self.device_spans()
        if not spans:
            return []
        edges = [self.t0] + [x for s in spans for x in s] + [self.t1]
        host = sorted(self.of(HOST_CATS), key=lambda e: float(e["ts"]))
        starts = [float(e["ts"]) for e in host]
        tot = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid, label = (a + b) / 2, "python"
            i = bisect.bisect_right(starts, mid)
            for e in reversed(host[max(0, i - HOST_SCAN):i]):
                if float(e["ts"]) + float(e["dur"]) >= mid:
                    label = e["name"]
                    break
            tot[label] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
