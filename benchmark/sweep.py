"""The live cell's knee: the highest stream count it sustains.

    python benchmark/sweep.py --streams 32,64,128,192,256,384 \
        --seconds 10 --seed 7 [--out FILE]

For each stream count, in one process: the live cell's set-up with that
many streams, then its paced window.  Printed per point: the p95 chunk
lag, the tick wall's median, and how late the generator started the
last ticks (a backlog grows where that keeps rising past a chunk
period).  The cell's stream count is then set at four fifths of the
highest count whose p95 lag stays within one chunk period with no
growing backlog.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import common  # noqa: E402

common.set_run_env()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.drivers.live import Cell  # noqa: E402
from benchmark.run import Run  # noqa: E402


def point(streams: int, seconds: float, seed: int, device="cuda",
          traffic_overrides=None) -> dict:
    run = Run("vawgan-vcc2016.live", seed, device,
              {**(traffic_overrides or {}), "streams": streams})
    cell = Cell(run)
    cell.setup()
    cell.window(seconds)
    walls = run.spans["bench.tick"]
    q = max(1, len(walls) // 4)
    out = {"streams": streams,
           "chunk_lag_p95_ms": run.end_to_end["chunk_lag_p95_ms"],
           "tick_ms_p50": 1e3 * float(np.median(walls)),
           "tick_ms_max": 1e3 * float(np.max(walls)),
           "ticks": len(walls), **run.notes,
           "late_ms_last_quarter": 1e3 * float(
               np.mean(cell.late[-q:])),
           "late_ms_first_quarter": 1e3 * float(np.mean(cell.late[:q]))}
    cell.release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: the knee is the card's", file=sys.stderr)
        return 2
    for n in (int(s) for s in args.streams.split(",")):
        line = json.dumps(point(n, args.seconds, args.seed))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
