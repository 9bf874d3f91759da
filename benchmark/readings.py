"""The readings that the limits of `correct` are set from, in one process.

    python3 benchmark/readings.py --workloads <cell>[,<cell>...] --seeds 1,2,3 \
        [--seconds 2] [--control int8 | --nprobe <n>] [--out readings.jsonl]

For every seed and cell: one run of the harness with a short window at the
cell's own size and load, its compared numbers and `correct`, one JSON line
each. `--control int8` runs the control instead: the program with its own
int8 field path switched on (the nearest type below the configuration's
bfloat16), which has to come out not correct. `--nprobe` plants a fault in
an IVF configuration: the program probes that many clusters instead of the
configuration's. The benchmark's own runs never run this script.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workloads", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", choices=("int8",))
    p.add_argument("--nprobe", type=int)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import torch

    from vdbbench import harness

    if not torch.cuda.is_available():
        print("readings are taken on the card", file=sys.stderr)
        return 2
    spec = harness.load_spec(HERE.parent)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            for cell in args.workloads.split(","):
                patch = {"precision": args.control} if args.control else {}
                if args.nprobe:
                    config = harness.config_of(spec, HERE.parent, harness.cell_of(spec, cell)["config"])
                    patch["index"] = {**config["index"], "nprobe": args.nprobe}
                r = harness.run_cell(cell, seed, args.seconds, False, program_patch=patch)
                line = json.dumps({"cell": cell, "seed": seed, "control": args.control,
                                   "nprobe": args.nprobe,
                                   "correct": r["correct"], "failed": r["failed"],
                                   "attempted": r["attempted"], "checks": r["checks"]})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
