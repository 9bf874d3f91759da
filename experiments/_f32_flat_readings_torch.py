"""Readings behind the limits of `correct` in the float32 flat cell
(`benchmark/configs/cohere768-1m-f32-flat.json`), on the card.

    python3 experiments/_f32_flat_readings_torch.py [--sound 1,2,3] [--control 4,5,6] \
        [--tf32 7,8,9] [--seconds 2]

For each seed of `--sound`: one run of the cell with a short window, its
compared numbers; of `--control`: the same run with the program's rows
stored in bfloat16, the nearest stored type below float32 (the numbers
have to read over the limits); of `--tf32`: no program at all, the plain
reference's own answer when rows and queries are rounded to TF32's 10
mantissa bits before they are scored (what a scan through TF32 tensor
cores would lose), judged by the same comparison. One JSON line each.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELL = "cohere768-1m-f32-flat.serial"


def tf32(x):
    """float32 values rounded to 10 mantissa bits, to nearest, ties to even."""
    import torch

    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def tf32_reading(config: dict, seed: int, n_queries: int, device: str = "cuda"):
    """The reference's exact top k over rows and queries rounded to TF32,
    judged against the float32 reference."""
    import numpy as np
    import torch

    from vdbbench import datagen, reference

    mix = datagen.Mixture(config["data"], config["dims"], seed, device)
    queries = mix.queries(n_queries).numpy()
    k, metric = config["top_k"], config["metric"]
    q = tf32(reference._prepared(torch.from_numpy(queries).to(device), metric, "float32").float())
    best_s = torch.full((n_queries, k), -float("inf"), dtype=torch.float64, device=device)
    best_i = torch.zeros((n_queries, k), dtype=torch.int64, device=device)
    for off, rows in mix.rows(config["rows"]):
        r = tf32(reference._prepared(rows, metric, "float32").float())
        s = q.double() @ r.double().T
        pos = off + torch.arange(r.shape[0], device=device).expand(n_queries, -1)
        best_s, best_i = reference._top(best_s, best_i, s, pos, k)
    pks = (best_i + 1).cpu().numpy()
    dists = reference._distance(metric, best_s).cpu().numpy()
    counts = np.full(n_queries, k, np.int64)
    return reference.judge(config, mix, queries, pks, dists, counts)["numbers"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sound", default="")
    p.add_argument("--control", default="")
    p.add_argument("--tf32", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--queries", type=int, default=256)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]
    import torch

    from vdbbench import harness

    if not torch.cuda.is_available():
        print("readings are taken on the card", file=sys.stderr)
        return 2
    spec = harness.load_spec(ROOT)
    config = harness.config_of(spec, ROOT, harness.cell_of(spec, CELL)["config"])

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    for kind, patch in (("sound", None), ("control", {"precision": "bfloat16"})):
        for seed in seeds(getattr(args, kind)):
            r = harness.run_cell(CELL, seed, args.seconds, False, program_patch=patch)
            print(json.dumps({"kind": kind, "seed": seed, "correct": r["correct"],
                              "attempted": r["attempted"], "failed": r["failed"],
                              "checks": r["checks"]}), flush=True)
            torch.cuda.empty_cache()
    for seed in seeds(args.tf32):
        numbers = tf32_reading(config, seed, args.queries)
        print(json.dumps({"kind": "tf32", "seed": seed, "numbers": numbers,
                          "limits": config["check"]["limits"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
