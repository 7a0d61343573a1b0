"""The control and the lower readings of a cell, on the card: for each
seed, a short run of the cell whose check also computes the control's
readings (the reference in float8 e4m3 in the program's place, against
the float32 reference on the same inputs and tokens). Prints one JSON line
a seed with the program's readings and verdict, and the control's
readings and verdict, judged against the cell's limits as the program's
are (over the numbers the control computes).

    python3 benchmark/control.py --workload <cell> --seconds 3 \
        --seeds 11 12 13

The benchmark's own runs never run the control.
"""

import time

import argparse
import json
import sys

import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench_run._environment()
    import torch

    import harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = harness.execute(args.workload, seed, args.seconds, False,
                            "cuda:0", time.perf_counter(), control=True)
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "control_correct": {
                              k: v["correct"]
                              for k, v in r["control_verdicts"].items()},
                          "control_checks": {
                              k: v["checks"]
                              for k, v in r["control_verdicts"].items()},
                          "readings": r["readings"],
                          "control": r["control"],
                          "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
