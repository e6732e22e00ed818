#!/usr/bin/env python3
"""Readings for a cell's correctness limits, in one process (set-up is
paid once for the kernels' build and load):

    python3 bench/calibrate.py --workload <cell> --seeds 12 --control 3 \
        --seconds 8 [--first-seed N] [--out FILE]

For each of ``--seeds`` seeds it runs the cell as ``bench/run.py`` does,
with a window of ``--seconds`` at the cell's own load, and records the
numbers compared (the lower reading is their largest over the seeds); on
the first ``--control`` seeds it also runs the control, the reference in
fp8 (``reference/plain.Matmul``), at the same positions (the upper reading
is the least of its widest gaps). One JSON line per seed on standard
output (and appended to ``--out``), a summary line last. The benchmark's
own runs never run the control."""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    lower, upper = {}, []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        res = run.run_cell(args.workload, seed, args.seconds, False, "cuda:0",
                           control=i < args.control)
        rd = res.pop("_readings")
        line = {"seed": seed, "numbers": rd["numbers"], "gaps": rd["gaps"], "errs": rd["errs"],
                "reference_s": rd["reference_s"], "requests": rd["requests"],
                "switches": rd["switches"], "correct": res["correct"]}
        if rd["control_gaps"]:
            line["control"] = {"logit_gap": max(rd["control_gaps"]),
                               "logit_err": max(rd["control_errs"])}
            line["control_gaps"], line["control_errs"] = rd["control_gaps"], rd["control_errs"]
            upper.append(line["control"])
        for k, v in line["numbers"].items():
            lower[k] = max(lower.get(k, v), v)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    summary = {"workload": args.workload, "lower": lower,
               "control_upper": {k: min(u[k] for u in upper) for k in upper[0]} if upper else None,
               "card": torch.cuda.get_device_name(0)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
