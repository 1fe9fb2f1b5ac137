"""Logdir management (reference util/wrapper.py validate_log_dirs).

The port's own copy of ``tpuvc/utils/logdir.py``.

Creates timestamped run directories logdir/train/<YYYYmmdd-HHMM-SS>/ like
the reference, or reuses an explicit --restore_from directory
(SURVEY.md SS2.1, SS5.4).
"""

from __future__ import annotations

import os
import time


def make_run_dir(logdir: str = "logdir", restore_from: str | None = None,
                 msg: str | None = None) -> str:
    if restore_from:
        if not os.path.isdir(restore_from):
            raise FileNotFoundError(restore_from)
        return restore_from
    stamp = time.strftime("%Y%m%d-%H%M-%S")
    run = os.path.join(logdir, "train", stamp)
    os.makedirs(run, exist_ok=True)
    if msg:
        with open(os.path.join(run, "msg.txt"), "w") as f:
            f.write(msg + "\n")
    return run
