"""Tracing and debugging hooks of the train CLI.

Port of the two functions of ``tpuvc/utils/profiling.py`` that
``cli/train.py`` uses, on ``torch.profiler`` and autograd's anomaly mode.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(logdir: str | None):
    """Profile the host and, where there is one, the CUDA card over the
    block, and write a Chrome trace (``trace.json``, viewable in Perfetto
    or chrome://tracing) into ``logdir``.  No-op when logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_debug_checks() -> None:
    """Fail fast on NaNs: autograd's anomaly mode raises where a backward
    produces one and names the forward operation that made it."""
    torch.autograd.set_detect_anomaly(True)
