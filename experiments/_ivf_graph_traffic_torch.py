"""The IVF probe's CUDA graphs (`ops/graphs.py`) under traffic of one key
and of many, on the card, beside the eager probe. Builds one 1M x 768 bf16
cosine index (nlist 1024, nprobe 16: the `cohere768-1m-ivf` deployment's
layout) from seeded clustered rows, then times `search_arrays(mode=
"probe")` over fixed sequences of (B, k):

- `b1`, `b4`, `b32`: one key, B = 1, 4, 32 and k = 100;
- `mix6`: B in (1, 4, 32) and k in (10, 100) drawn at random, 6 keys;
- `mix12`: B in (1, 2, 4, 8, 16, 32) and k in (10, 100), 12 keys;
- `mix32`: B drawn from 1..32, k = 100, 32 keys.

Each sequence runs as blocks in turns, each block from an empty cache:
`eager` (the graph path turned off), and on a checkout that has the
graphs `graph8` / `graph64` (the cache bounded to 8 / 64 entries),
ordered eager, graph8, graph64, graph64, graph8, eager. A block prints
host ms a search (mean, median, p99), queries a second, the keys captured
and the searches replayed, and the device memory the block's entries
reserved. Then the first three searches of a new key (eager, capture,
replay) in ms, at B = 1 and 32.

    python3 experiments/_ivf_graph_traffic_torch.py [checkout root] [label]

The checkout root (default: this one) goes first on sys.path, so that one
command can run a parent (eager blocks only) and a change, one process each.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

N, D, C, NPROBE, MODES, CHUNK = 1_000_000, 768, 1024, 16, 2000, 125_000
DEVICE = "cuda"
PATTERNS = {
    "b1": ([1], [100], 1000),
    "b4": ([4], [100], 600),
    "b32": ([32], [100], 300),
    "mix6": ([1, 4, 32], [10, 100], 900),
    "mix12": ([1, 2, 4, 8, 16, 32], [10, 100], 900),
    "mix32": (list(range(1, 33)), [100], 900),
}


def main():
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])
    label = sys.argv[2] if len(sys.argv) > 2 else root.name
    sys.path.insert(0, str(root))
    import torch

    from tostore_tpu_torch import IVFVectorIndex
    from tostore_tpu_torch.ops import ivfprobe
    from tostore_tpu_torch.vector import ivf as ivf_mod

    has_graphs = hasattr(ivf_mod, "_probe_graph_eligible")
    rng = np.random.default_rng(18)
    centers = rng.standard_normal((MODES, D), dtype=np.float32) * 3
    idx = IVFVectorIndex(D, "cosine", "bfloat16", num_clusters=C, nprobe=NPROBE, device=DEVICE)
    idx.defer_retrain = True
    for off in range(0, N, CHUNK):
        x = centers[rng.integers(0, MODES, CHUNK)] + rng.standard_normal((CHUNK, D),
                                                                         dtype=np.float32)
        idx.upsert(range(off, off + CHUNK), x)
    idx.defer_retrain = False
    idx.train(force=True)
    pool = (centers[rng.integers(0, MODES, 4096)]
            + rng.standard_normal((4096, D), dtype=np.float32)).astype(np.float32)
    torch.cuda.synchronize()
    print(json.dumps({"label": label, "graphs": has_graphs,
                      "layout": list(idx.buckets_slots.shape)}), flush=True)

    def block(seq, side):
        if has_graphs:
            from tostore_tpu_torch.ops import graphs
            graphs.MAX_ENTRIES = {"graph8": 8, "graph64": 64}.get(side, 8)
            idx._probe_graphs.clear()
            eligible = ivf_mod._probe_graph_eligible
            if side == "eager":
                ivf_mod._probe_graph_eligible = lambda *a: False
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        g0 = {k: ivfprobe.LAUNCHES.get(k, 0)
              for k in ("ivf_probe_graph", "ivf_probe_graph_capture")}
        ms, nq = [], 0
        t_all = time.perf_counter()
        for b, k, off in seq:
            t0 = time.perf_counter()
            idx.search_arrays(pool[off: off + b], k, mode="probe")
            ms.append((time.perf_counter() - t0) * 1e3)
            nq += b
        total = time.perf_counter() - t_all
        if has_graphs:
            ivf_mod._probe_graph_eligible = eligible
        row = {"side": side, "mean_ms": total * 1e3 / len(seq),
               "median_ms": float(np.median(ms)), "p99_ms": float(np.percentile(ms, 99)),
               "qps": nq / total,
               "captures": ivfprobe.LAUNCHES.get("ivf_probe_graph_capture", 0)
               - g0["ivf_probe_graph_capture"],
               "replays": ivfprobe.LAUNCHES.get("ivf_probe_graph", 0) - g0["ivf_probe_graph"],
               "entries": len(idx._probe_graphs) if has_graphs else 0,
               "reserved_mb": (torch.cuda.memory_reserved() - reserved) / 2**20}
        return row

    sides = ["eager", "graph8", "graph64", "graph64", "graph8", "eager"] if has_graphs \
        else ["eager", "eager"]
    for i, (name, (bs, ks, n)) in enumerate(PATTERNS.items()):
        prng = np.random.default_rng(1800 + i)
        seq = [(int(b), int(k), int(prng.integers(0, 4096 - b)))
               for b, k in zip(prng.choice(bs, n), prng.choice(ks, n))]
        block(seq[:50], "eager")  # every shape's kernels loaded before the first timed block
        for side in sides:
            print(json.dumps({"label": label, "pattern": name, **block(seq, side)}), flush=True)

    if has_graphs:
        for b in (1, 32):
            idx._probe_graphs.clear()
            ms = []
            for i in range(3):
                t0 = time.perf_counter()
                idx.search_arrays(pool[i * b: (i + 1) * b], 64, mode="probe")
                ms.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps({"label": label, "new_key_B": b, "k": 64,
                              "eager_capture_replay_ms": ms}), flush=True)


if __name__ == "__main__":
    main()
