"""The least time K1, the flat scan's running per-lane top-T kernel, could
take for what a flat search must read, and K1's device time in a traced
window.

The work comes from the configuration alone, so it stays the same whatever
implements K1: the rows read once in the field's type, plus the queries and
the hits (`roofline.scan_work`), at the rates of `roofline.py`; per query,
a call of `batch` queries shares the rows. Padding, the bias and the slots
past the live rows are not counted, so K1's share reads below what it
streams, never above 100%. Other index types have no count here.

K1 is found by name: on f32 rows `lane_topk_kernel<float, BM, T, false>`
(csrc/lane_topk.cu), on bf16 and int8 rows `lane_scan_kernel<I8, NQ, T>`
(csrc/lane_scan.cuh), each with T > 0; the same templates with T = 0 are
K2 and the grouped scan K5.
"""

from __future__ import annotations

import re

from .roofline import least_ms_per_query as _flat_or_probe

# the template's last size argument is T, the running list's depth
KERNEL = re.compile(r"(?:lane_topk_kernel\W+float|lane_scan_kernel\W+(?:true|false))"
                    r"\W+\d+\W+(\d+)")


def least_ms_per_query(config: dict, batch: int) -> float | None:
    """The bound of a flat scan of `batch` queries, per query; None for
    another index type."""
    if config["index"]["index_type"] != "flat":
        return None
    return _flat_or_probe(config, batch)


def is_k1(name: str) -> bool:
    m = KERNEL.search(name)
    return m is not None and int(m.group(1)) > 0


def kernel_s(trace) -> float:
    """The device time (s) of K1's kernels in the window."""
    return sum(float(e["dur"]) for e in trace.of({"kernel"}) if is_k1(e["name"])) / 1e6
