"""The program's own spans in a traced window.

The port records each stage of a search as a `record_function` named
`tostore.<name>` while a profiler is open (`tostore_tpu_torch/utils/
spans.py`): `user_annotation` events of the Chrome trace, on the same
clock as the aten operators, the CUDA calls and the kernels. Their
device-side copies (`gpu_user_annotation`) are not read. A window traced
on a program without spans holds none: `span_ms` is then None and
`span_table` has the one row `outside`.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from .traceread import SYNC_CALLS

PREFIX = "tostore."
OUTSIDE = "outside"


def marks(trace) -> list[tuple[float, float, str]]:
    """(start, end, name) of each span in the window (us, cut to it), the
    name without its prefix."""
    return [(max(float(e["ts"]), trace.t0), min(float(e["ts"]) + float(e["dur"]), trace.t1),
             e["name"][len(PREFIX):])
            for e in trace.events
            if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)]


def span_ms(trace, name: str) -> float | None:
    """The summed duration (ms) of the span `tostore.<name>` in the window;
    None where the window holds none."""
    durs = [b - a for a, b, n in marks(trace) if n == name]
    return sum(durs) / 1e3 if durs else None


def per_query(ctx, name: str) -> float | None:
    """`span_ms` over the queries the window answered: a per-layer reading."""
    ms = span_ms(ctx.trace, name)
    return ms / ctx.window.queries if ms is not None and ctx.window.queries else None


def owners(trace) -> list[tuple[float, float, str]]:
    """The window cut into [start, end) pieces, each with the span that owns
    it: the innermost open span, which is the one opened last (of two
    opened together, the shorter), whatever thread it is on; `outside`
    where none is open."""
    ms = marks(trace)
    edges = sorted({trace.t0, trace.t1, *(x for a, b, _ in ms for x in (a, b))})
    order = sorted(range(len(ms)), key=lambda i: ms[i][0])
    active: dict[int, tuple] = {}
    out, j = [], 0
    for a, b in zip(edges, edges[1:]):
        while j < len(order) and ms[order[j]][0] <= a:
            active[order[j]] = ms[order[j]]
            j += 1
        for i in [i for i, m in active.items() if m[1] <= a]:
            del active[i]
        owner = OUTSIDE
        if active:
            owner = active[max(active, key=lambda i: (active[i][0], -active[i][1], i))][2]
        out.append((a, b, owner))
    return out


def _idle(trace) -> list[tuple[float, float]]:
    """The window's intervals (us) in which the device ran nothing."""
    out, t = [], trace.t0
    for a, b in trace.device_spans():
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if trace.t1 > t:
        out.append((t, trace.t1))
    return out


def span_table(trace, queries: int) -> dict:
    """Per query, for each span name and for `outside`: `ms`, the span's
    whole time; `self_ms`, the time it owned (`owners`); `idle_ms`, the
    device's idle time while it owned the moment, by intersection of the
    intervals; `syncs`, the CUDA calls that block the host
    (traceread.SYNC_CALLS) that start while it owns the moment. Over the
    rows, `self_ms` sums to the window and `idle_ms` to its idle time."""
    n = max(1, queries)
    pieces = owners(trace)
    rows = defaultdict(lambda: {"ms": 0.0, "self_ms": 0.0, "idle_ms": 0.0, "syncs": 0})
    for a, b, name in marks(trace):
        rows[name]["ms"] += b - a
    for a, b, name in pieces:
        rows[name]["self_ms"] += b - a
    rows[OUTSIDE]["ms"] = rows[OUTSIDE]["self_ms"]
    idle, k = _idle(trace), 0
    for a, b, name in pieces:
        while k < len(idle) and idle[k][1] <= a:
            k += 1
        i = k
        while i < len(idle) and idle[i][0] < b:
            rows[name]["idle_ms"] += min(b, idle[i][1]) - max(a, idle[i][0])
            i += 1
    starts = [a for a, _, _ in pieces]
    for e in trace.of({"cuda_runtime", "cuda_driver"}):
        if e["name"] in SYNC_CALLS:
            i = bisect.bisect_right(starts, float(e["ts"])) - 1
            if 0 <= i < len(pieces):
                rows[pieces[i][2]]["syncs"] += 1
    out = {}
    for name in sorted(rows, key=lambda r: (r == OUTSIDE, -rows[r]["ms"])):
        r = rows[name]
        out[name] = {"ms": r["ms"] / 1e3 / n, "self_ms": r["self_ms"] / 1e3 / n,
                     "idle_ms": r["idle_ms"] / 1e3 / n, "syncs": r["syncs"] / n}
    return out
