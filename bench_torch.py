"""Headline benchmark of the PyTorch port: batched flat kNN QPS at 1M x 768
bf16, k = 10, B = 256 (the shape of `bench.py`, the JAX package's).

    python3 bench_torch.py                # the card: 1,003,520 x 768 bf16, B = 256
    python3 bench_torch.py --device cpu   # tiny shape (4096 x 128, B = 8), for tests

BASELINE.json north-star config #2: vs_baseline = achieved QPS / 10,000.
`flat_search` in mode "auto" takes K2 (lane_topk_emit, csrc/lane_scan.cuh)
at B = 256 on the card. Timing keeps `bench.py`'s definition (`timeit`).

Prints a line `launches {...}` (the kernels' launch counters over the
timing, its warm-up call included) and then ONE JSON line: {"metric", "value", "unit",
"vs_baseline", "device"}. Any failure raises and exits non-zero; without a
card the default device raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0


def device_info(device: str) -> dict:
    """The device a run measured: on the card its name and power limit as
    nvidia-smi reports them, and the torch / CUDA versions."""
    info = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if torch.device(device).type != "cuda":
        return {"name": "cpu", "power_limit": None, **info}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    return {"name": name, "power_limit": limit, **info}


def require_device(device: str) -> torch.device:
    """torch.device(device); raises SystemExit for a CUDA device on a
    machine without one (a measurement never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{sys.argv[0]}: device {device!r} asked for, but "
                         f"torch.cuda.is_available() is False")
    return dev


def sync():
    """Wait for the card (a no-op without one)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timeit(fn, *args, reps=30, trials=3):
    """Seconds a call, as bench.py:47-56 and bench_all.py:24-33 define it:
    one warm-up call, then the best of `trials` trials, each the mean of
    `reps` back-to-back calls. The card is synchronised at both ends of a
    trial, in place of the reference's host readback."""
    fn(*args)
    sync()
    best = float("inf")
    for _ in range(trials):
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        sync()
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def normal_chunks(seed: int, n: int, d: int, chunk_rows: int = 131072):
    """(offset, [m, d] f32 rows) from np.random.default_rng(seed), made on
    the host chunk by chunk."""
    rng = np.random.default_rng(seed)
    for off in range(0, n, chunk_rows):
        yield off, rng.standard_normal((min(chunk_rows, n - off), d), dtype=np.float32)


def normal(seed: int, shape, dev, dtype=torch.float32):
    """Seeded standard-normal [n, d] rows (`normal_chunks`), cast to `dtype`
    on `dev` chunk by chunk: no full f32 copy on the card."""
    out = torch.empty(shape, dtype=dtype, device=dev)
    for off, x in normal_chunks(seed, *shape):
        out[off:off + len(x)] = torch.from_numpy(x).to(dev).to(dtype)
    return out


def launch_counts() -> dict:
    from tostore_tpu_torch.ops import ivfprobe, topk

    return {**topk.LAUNCHES, **ivfprobe.LAUNCHES}


def zero_launch_counts():
    from tostore_tpu_torch.ops import ivfprobe, topk

    for table in (topk.LAUNCHES, ivfprobe.LAUNCHES):
        for key in table:
            table[key] = 0


def run(device: str = "cuda") -> dict:
    from tostore_tpu_torch.ops import topk
    from tostore_tpu_torch.ops.runtime import round_up

    dev = require_device(device)
    if dev.type == "cuda":
        n = round_up(1_000_000, 4096)
        d, k, b = 768, 10, 256
        reps = 30
    else:  # tests: tiny shapes, same code path
        n, d, k, b = 4096, 128, 10, 8
        reps = 3

    corpus = normal(SEED, (n, d), dev, torch.bfloat16)
    bias = torch.zeros(n, dtype=torch.float32, device=dev)
    q = normal(SEED + 1, (b, d), dev)

    def fn():
        return topk.flat_search(q, corpus, bias, k=k)

    fn()  # the kernels' build at first use, outside the counted calls
    zero_launch_counts()
    best = timeit(fn, reps=reps)
    print("launches " + json.dumps(launch_counts()), flush=True)

    qps = b / best
    return {
        "metric": f"flat_knn_qps_b{b}_{n}x{d}_bf16_top{k}",
        "value": round(qps, 1),
        "unit": "QPS",
        "vs_baseline": round(qps / 10_000.0, 3),
        "device": device_info(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
