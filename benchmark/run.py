"""The benchmark of `tostore_tpu_torch`: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up (data and queries from the seed, the load, the first search,
the IVF index's training by the engine, warm-up) counts as `setup_s`; then
the cell's traffic runs for `--seconds` (with `--trace 1` a shorter window
under torch.profiler), the program is closed, and the sampled answers are
compared with the plain reference. The last line of standard output is the
result, the last lines of standard error each compared number beside its
limit. It exits non-zero, printing no result, without enough cards, or if
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

STEADY = "VDBBENCH_T_START"  # set once this process has fixed its layout


def steady_layout():
    """Starts this run again, in the same process, with one string hash seed
    and no address randomisation, so that every run has the same
    interpreter layout: the host's Python does most of a search's work, and
    this takes the interpreter's own per-process randomness out of the
    comparison of runs. The start time carries over into `setup_s`."""
    if STEADY in os.environ:
        return float(os.environ[STEADY])
    os.environ[STEADY] = repr(T_START)
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        persona = libc.personality(0xFFFFFFFF)  # read only
        if persona != -1:
            libc.personality(persona | 0x0040000)  # ADDR_NO_RANDOMIZE
    except (OSError, AttributeError):
        pass  # the interpreter's default layout, as before
    os.execv(sys.executable, [sys.executable, *sys.argv])


if __name__ == "__main__":
    T_START = steady_layout()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout: BENCHMARK.json and the program
CACHE = ROOT / ".benchcache"  # build caches of anything that compiles: fixed paths in the checkout


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info() -> str:
    """The card's name and power limit as nvidia-smi reports them (copied
    from bench_torch.py's `device_info`)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    import torch

    sys.path[:0] = [str(HERE), str(ROOT)]
    from vdbbench import harness

    cell = harness.cell_of(harness.load_spec(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    harness.log("device", device_info(), "torch", torch.__version__, "cuda", torch.version.cuda)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", root=ROOT, t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
