#!/usr/bin/env python3
"""One traced run of a cell, with the window's idle named by the program's
own spans as well as the harness's:

    python3 bench/breakdown.py --workload <cell> --seed <n> --seconds <s> [--out f.json]

It runs the cell as ``bench/run.py --trace 1`` does (its per-layer
metrics put the card tracer in place), keeps the profiler's raw events,
and prints one JSON line: the run's metrics, the harness's breakdown
(``trace.reduce_events``), and ``spans.reduce_program`` over the same
events (each ``mma.*`` span's host, self and device seconds and memcpy
time, and the idle seconds by innermost program span). Both idle totals
are printed, and they are equal; ``named_share`` gives, for each harness
span, the share of its idle that a program span inside it names. Needs the card the cell needs.
"""
import argparse
import json
import sys

import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="also write the line to this file")
    args = ap.parse_args(argv)
    bench_run.prepare_environment()
    import torch
    from benchkit import spans, trace

    if not torch.cuda.is_available():
        print("breakdown: no CUDA card", file=sys.stderr)
        return 2
    kept = {}
    reduce_events = trace.reduce_events

    def keep(events, *a, **kw):               # the events, reduced twice
        kept["events"] = list(events)
        kept["summary"] = reduce_events(kept["events"], *a, **kw)
        return kept["summary"]

    trace.reduce_events = keep
    try:
        result = bench_run.run_cell(args.workload, args.seed, args.seconds, True, "cuda:0")
    finally:
        trace.reduce_events = reduce_events
    program = spans.reduce_program(kept["events"])
    harness = kept["summary"].idle_by_host
    line = {"workload": args.workload, "seed": args.seed,
            "device": result["device"], "metrics": result["metrics"],
            "correct": result["correct"], "breakdown": result["breakdown"],
            "harness_idle_s": sum(harness.values()),
            "program_idle_s": sum(program.idle.values()),
            "harness_idle": dict(harness), "program": program.as_dict(),
            # of the idle the harness names after a span of its own, the
            # share a program span inside it names
            "named_share": {n: 1.0 - program.idle.get(n, 0.0) / v
                            for n, v in harness.items() if n != "bench.host" and v}}
    text = json.dumps(bench_run._finite(line))
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
