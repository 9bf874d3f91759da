"""The least time the card could take for the work a search needs.

Copied from `chip_smoke.py:289-312` (`HBM_BPS`, `PEAK_FLOPS`, `_bound`, and
the byte and operation count of `_scan_bound`), so that a later change to
the smoke cannot move the yardstick. Two changes: the count is taken from
the configuration's shapes instead of from tensors, and it leaves out what
only the program's layout reads (the per-row bias and padding): the work
is the corpus read once per call, the queries read once and the top-k
(f32 score + int32 position a hit) written once, whichever kernels do it.

Peaks of one NVIDIA H100 SXM (data sheet, dense): 3.35 TB/s of HBM, 989
TFLOP/s in bf16, 1,979 TOP/s in int8, 67 TFLOP/s in f32 outside the tensor
cores. They assume the 700 W power limit; the run prints the card's.
"""

from __future__ import annotations

HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}
ELEM_BYTES = {"bfloat16": 2, "int8": 1, "float32": 4}
QUERY_BYTES = 2  # queries are read in bf16
HIT_BYTES = 8  # an f32 score and an int32 position


def bound_ms(nbytes: float, flops: float, precision: str) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes over the HBM rate and
    the operations over the peak rate of the field's type."""
    tb = nbytes / HBM_BPS * 1e3
    tf = flops / PEAK_FLOPS[precision] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def scan_work(n: int, d: int, precision: str, b: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of a flat scan of B queries over n rows."""
    nbytes = n * d * ELEM_BYTES[precision] + b * d * QUERY_BYTES + b * k * HIT_BYTES
    return nbytes, 2.0 * b * n * d


def probe_work(n: int, d: int, precision: str, clusters: int, nprobe: int, b: int,
               k: int) -> tuple[float, float]:
    """(bytes, operations) of an IVF probe of B queries: per query the C f32
    centroids and nprobe x n / C rows."""
    rows = nprobe * n / clusters
    per_query = rows * d * ELEM_BYTES[precision] + clusters * d * 4 + d * QUERY_BYTES + k * HIT_BYTES
    return b * per_query, 2.0 * b * d * (clusters + rows)


def least_ms_per_query(config: dict, batch: int) -> float | None:
    """The bound of one call of `batch` queries on a configuration, per
    query; None where no count is written here (IVF-PQ, other types)."""
    n, d, k, p = config["rows"], config["dims"], config["top_k"], config["precision"]
    index = config["index"]
    if index["index_type"] == "flat":
        work = scan_work(n, d, p, batch, k)
    elif index["index_type"] == "ivf" and not index.get("pq_subspaces"):
        work = probe_work(n, d, p, index["num_clusters"], index["nprobe"], batch, k)
    else:
        return None
    return bound_ms(*work, p)[0] / batch
