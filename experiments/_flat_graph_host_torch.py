"""Flat single-query search on the card, one process holding two versions
of the port: ms a search of `FlatVectorIndex.search(q, top_k=100)` over a
1M x 768 bf16 cosine table loaded in 20,000-row batches (capacity
1,310,720 slots, as the benchmark's flat cells hold it), in blocks taken in
turns, for each variant:

  - `base`: the package at `--base` (imported as `tostore_tpu_torch_base`);
  - `change`: this checkout's package, K1's route as one CUDA graph over
    the live prefix;
  - `prefix_eager`: the same index with no graph entry (the prefix alone);
  - `graph_whole`: a second index of this package whose prefix is the
    whole capacity (the graph alone).

`--base` is the root of a private copy of the version to compare with,
unpacked inside this checkout in a directory `.gitignore` lists: the
script builds that copy's kernels into it.

    git archive <commit> | (mkdir -p _scratch_tree/base && tar -x -C _scratch_tree/base)
    python3 experiments/_flat_graph_host_torch.py --base _scratch_tree/base [--blocks 16]

Prints one JSON line (medians and every block's ms a search) and writes it
to bench_out/flat_graph_host.json.
"""

import argparse
import importlib.util
import json
import statistics
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

ROWS, DIMS, BATCH, K = 1_000_000, 768, 20_000, 100


def load_base(root: str):
    here = Path(__file__).resolve().parents[1]
    if here not in Path(root).resolve().parents:
        raise SystemExit(f"--base {root}: not a copy inside this checkout ({here})")
    pkg = Path(root).resolve() / "tostore_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "tostore_tpu_torch_base", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def build(pkg, seed: int):
    idx = pkg.FlatVectorIndex(DIMS, "cosine", "bfloat16", device="cuda")
    rng = np.random.default_rng(seed)
    for off in range(0, ROWS, BATCH):
        idx.upsert(list(range(off, off + BATCH)),
                   rng.standard_normal((BATCH, DIMS), dtype=np.float32))
    return idx


@contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--per-block", type=int, default=100)
    ap.add_argument("--seed", type=int, default=1_900_000_017)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # this checkout first
    import tostore_tpu_torch as P
    from tostore_tpu_torch.ops import graphs
    from tostore_tpu_torch.vector import flat as flat_mod

    base = load_base(args.base)
    idx = {"base": build(base, args.seed), "change": build(P, args.seed),
           "graph_whole": build(P, args.seed)}
    runs = {
        "base": (idx["base"], nullcontext),
        "change": (idx["change"], nullcontext),
        "prefix_eager": (idx["change"], lambda: patched(graphs.GraphCache, "acquire",
                                                        lambda self, key, held: None)),
        "graph_whole": (idx["graph_whole"],
                        lambda: patched(flat_mod.ScanState, "prefix", lambda self, c: (
                            c.vectors, c.valid, c.sq_norms, c.scales))),
    }
    q = np.random.default_rng(args.seed + 1).standard_normal((4096, DIMS), dtype=np.float32)
    hits = {}
    for name, (ix, ctx) in runs.items():  # warm: each key recorded and captured
        with ctx():
            for i in range(4):
                ix.search(q[i], top_k=K)
            hits[name] = [h.primary_key for h in ix.search(q[7], top_k=K)]
    same = all(h == hits["base"] for h in hits.values())
    ms = {name: [] for name in runs}
    names = list(runs)
    for blk in range(args.blocks):
        for name in names[blk % len(names):] + names[: blk % len(names)]:
            ix, ctx = runs[name]
            with ctx():
                t0 = time.perf_counter()
                for i in range(args.per_block):
                    ix.search(q[(blk * args.per_block + i) % len(q)], top_k=K)
                ms[name].append((time.perf_counter() - t0) * 1e3 / args.per_block)
    out = {"device": torch.cuda.get_device_name(0), "same_hits": same,
           "capacity": idx["change"].corpus.capacity,
           "scan_rows": idx["change"].corpus.scan.prefix(idx["change"].corpus)[0].shape[0],
           "median_ms": {n: statistics.median(v) for n, v in ms.items()},
           "blocks_ms": ms}
    line = json.dumps(out)
    print(line, flush=True)
    Path("bench_out").mkdir(exist_ok=True)
    Path("bench_out/flat_graph_host.json").write_text(line + "\n")


if __name__ == "__main__":
    main()
