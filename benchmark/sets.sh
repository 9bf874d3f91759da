#!/usr/bin/env bash
# Runs of one cell as a check makes them, each seed in its own process:
#   OUT_DIR=<dir> bash benchmark/sets.sh <cell> <seconds> <trace> <seed>...
# from the root of a checkout. The result lines go to
# $OUT_DIR/sets_<cell>_t<trace>.jsonl (OUT_DIR defaults to bench_out), each
# run's set-up, window and check lines to the .log beside it.
set -u
cell=$1; seconds=$2; trace=$3; shift 3
dir=${OUT_DIR:-bench_out}
out="$dir/sets_${cell}_t${trace}"
mkdir -p "$dir"
for seed in "$@"; do
  python3 benchmark/run.py --workload "$cell" --seed "$seed" --seconds "$seconds" --trace "$trace" \
    2> >(grep -E '^(setup|window|probe|check|device)' | sed "s/^/$seed /" >> "$out.log") \
    | tail -n 1 >> "$out.jsonl"
  echo "$cell seed $seed rc ${PIPESTATUS[0]}"
done
