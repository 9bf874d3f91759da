"""The least time K3, the IVF probe's scan (`ivf_bucket_probe` with its
grouping pre-pass `ivf_group_pairs`), could take for what a probe must
read, and K3's device time in a traced window.

The bytes a query needs come from the configuration alone, so they stay
the same whatever implements K3: nprobe x N / C rows (the average rows of
nprobe clusters) of D values in the field's type, each row's f32 bias, and
the query in bf16, read once at the HBM rate of `roofline.py`. The port's
layout pads every slice to twice the average cluster, so K3 reads more
than this count and its share reads below what it streams, never above
100%. IVF-PQ and other index types have no count here.
"""

from __future__ import annotations

from .roofline import ELEM_BYTES, HBM_BPS, QUERY_BYTES

BIAS_BYTES = 4  # a row's f32 bias (validity; -|x|^2 for l2)
# the kernels as the trace names them: K3 (bf16 and int8 rows through the
# tensor cores, f32 rows without) and the grouping pre-pass it launches
KERNELS = ("ivf_probe_wgmma_kernel", "ivf_probe_f32_kernel", "ivf_group_kernel")


def bytes_per_query(config: dict) -> float | None:
    """The bytes one query's probe must read; None without a count."""
    index = config["index"]
    if index.get("index_type") != "ivf" or index.get("pq_subspaces"):
        return None
    rows = index["nprobe"] * config["rows"] / index["num_clusters"]
    d = config["dims"]
    return rows * (d * ELEM_BYTES[config["precision"]] + BIAS_BYTES) + d * QUERY_BYTES


def least_ms_per_query(config: dict) -> float | None:
    nbytes = bytes_per_query(config)
    return None if nbytes is None else nbytes / HBM_BPS * 1e3


def kernel_s(trace) -> float:
    """The device time (s) of K3's kernels in the window."""
    return sum(float(e["dur"]) for e in trace.of({"kernel"})
               if any(k in e["name"] for k in KERNELS)) / 1e6
