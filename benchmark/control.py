"""Readings that the correctness limits are set from, on the card.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 4 [--halves] [--out FILE]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, then the numbers the check compares, read twice on the
same sample: for the program, and for the control (the reference one
precision step lower, put in the program's place).  The lower reading
of a limit is the largest the program gives over a dozen seeds or more,
the upper the smallest the control gives.  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import common  # noqa: E402

common.set_run_env()

import torch  # noqa: E402

from benchmark.run import Run  # noqa: E402


def readings(cell: str, seed: int, seconds: float, device="cuda",
             traffic_overrides=None, config_overrides=None,
             halves: bool = False) -> dict:
    run = Run(cell, seed, device, traffic_overrides, config_overrides)
    drv = importlib.import_module(
        f"benchmark.drivers.{run.traffic['kind']}").Cell(run)
    t0 = time.perf_counter()
    drv.setup()
    drv.window(seconds)
    drv.release()
    out = drv.control_readings(halves)
    return {"cell": cell, "seed": seed, "attempted": run.attempted,
            "failed": run.failed, **out, "end_to_end": run.end_to_end,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out")
    ap.add_argument("--halves", action="store_true",
                    help="also read each half of a serving cell's control")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: the readings are the card's", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(args.workload, seed, args.seconds,
                                   halves=args.halves))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
