"""Readings from which a cell's limits are set: the program's numbers on
many seeds, and each control's on the same seeds, in one process.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 --seconds 3 \\
        --controls tf32,half_batch [--out FILE]

Each seed is a whole run of the cell (set-up, a short window at the cell's
own load, the comparison), then every named control is put in the
program's place on the same inputs and compared with the same reference:
``tf32`` and ``fp8`` the reference a precision below the configuration's,
``half_batch`` the loss over half of each batch (train cells). One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .run import finite, run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", default="", help="comma-separated")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    controls = [c for c in args.controls.split(",") if c]
    out = open(args.out, "a") if args.out else sys.stdout
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            line, res = run_cell(args.workload, seed, args.seconds, False, "cuda",
                                 controls=controls, t0=time.perf_counter())
            rec = {"seed": seed, "readings": res.readings, "holds": res.holds,
                   "controls": res.controls, "correct": line["correct"], "notes": res.notes,
                   "metrics": {k: v["value"] for k, v in line["metrics"].items()}}
            print(json.dumps(finite(rec)), file=out, flush=True)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
