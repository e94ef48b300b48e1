"""The readings that a cell's limits are set from, many seeds in one
process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--seconds 3] [--out readings.jsonl]

Each seed is one run of the cell, as `run.py` makes it, with a short
window and the calibration readings on: the program's compared numbers,
the fp8 control's (the reference in the program's place, its conv and
matrix operands rounded to float8 e4m3), and for training the half-batch
fault's. One JSON line a seed; at the end, for each number, the largest
reading of the program (the lower reading) and the smallest of the
control and of each fault (the upper readings).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from perfbench import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res, _, _ = core.run_cell(args.workload, seed, args.seconds, False,
                                  device, time.perf_counter(),
                                  calibrate=True)
        row = {"seed": seed, "correct": res["correct"],
               "program": {k: v["value"] for k, v in res["checks"].items()},
               **res["readings"], "metrics": res["metrics"]}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    summary = {"lower": {}, "upper": {}}
    for k in rows[0]["program"]:
        summary["lower"][k] = max(r["program"][k] for r in rows)
        for side in ("control_fp8", "fault_half_batch"):
            if k in rows[0].get(side, {}):
                summary["upper"].setdefault(side, {})[k] = min(
                    r[side][k] for r in rows)
    print("SUMMARY " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
