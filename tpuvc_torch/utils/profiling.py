"""Tracing and debugging hooks: the train CLI's trace export and the
program's stage spans.

``trace`` and ``enable_debug_checks`` port the two functions of
``tpuvc/utils/profiling.py`` that ``cli/train.py`` uses, on
``torch.profiler`` and autograd's anomaly mode.

``span`` marks a stage of the program (the serving path, the streaming
tick, the trainer) with a ``torch.profiler.record_function`` range while a
profiler records: ``cli.train --profile``, the benchmark's traced runs or
any other ``torch.profiler`` run.  The ranges are the profiler's host
events, on the clock of the device's events in the same trace.  With no
profiler a span asks once whether one records (well under a microsecond)
and enters a shared null context; it needs no setting to turn it on or
off.  Spans sit at stage boundaries, never inside a per-frame loop.  A span
records only in a thread the profiler follows: the shard threads of a
device mesh open theirs under the same names.
"""

from __future__ import annotations

import contextlib
import os

import torch

# the context a span returns while no profiler records: entered and left
# any number of times, from any thread
NULL_SPAN = contextlib.nullcontext()

_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records
    in this thread, else ``NULL_SPAN``; use as ``with span("vc.prep"):``."""
    if _recording():
        return torch.profiler.record_function(name)
    return NULL_SPAN


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
