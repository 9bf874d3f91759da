"""One traced run of a cell, as `run.py --trace 1` makes it, whose result
line also carries `breakdown.spans`: the program's span table of the traced
window (`vdbbench.spans.span_table`: per query, each `tostore.` span's
time, self time, the device's idle time it owns and the host syncs that
start in it, and the same for `outside` any span).

    python3 benchmark/span_table.py --workload <cell> --seed <n> --seconds <s>

From the root of a checkout, on the card. The run is `run.py`'s, with its
metrics and its comparison; the table is read from the same trace after
the run.
"""

import sys

import run


def main(argv=None) -> int:
    sys.path[:0] = [str(run.HERE), str(run.ROOT)]
    from vdbbench import harness, spans

    kept = []
    traced, run_cell = harness._traced, harness.run_cell

    def keep(win, seconds, cuda):
        tr = traced(win, seconds, cuda)
        kept.append((tr, win))
        return tr

    def with_spans(*a, **kw):
        result = run_cell(*a, **kw)
        if kept:
            tr, win = kept[0]
            result.setdefault("breakdown", {})["spans"] = spans.span_table(tr, win.queries)
        return result

    harness._traced, harness.run_cell = keep, with_spans
    return run.main([*(sys.argv[1:] if argv is None else argv), "--trace", "1"])


if __name__ == "__main__":
    run.T_START = run.steady_layout()
    sys.exit(main())
