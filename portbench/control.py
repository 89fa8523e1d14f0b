#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's and the control's.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--out FILE]

runs the cell once a seed in this process, at its own size, and prints a
JSON line a seed: the numbers the comparison gave for the program (the
lower readings) and for the control, the plain reference computed in the
nearest precision below the configuration's and put in the program's
place (TF32 for float32 with TF32 off; float8 e4m3 rounding at every
bfloat16 cast for the bfloat16 policy), against the same reference (the
upper readings).  The benchmark's own runs never compute the control.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_environment()
    import torch
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 3
    print(harness.power_limit(), file=sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             control=True)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "correct": r["correct"], "program": r["program"],
                           "control": r["control"], "faults": r["faults"],
                           "metrics": r["metrics"],
                           "memory_peak_bytes":
                               r["device"]["memory_peak_bytes"],
                           "wall_s": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
