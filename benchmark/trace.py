"""The device trace of a traced run and what the metrics read from it.

``torch.profiler`` (CPU and CUDA activities) runs over the first
``TRACE_S`` seconds of the measured window (reducing a whole window's
millions of events would take minutes); the traced stretch is marked by
the benchmark's own range ``bench.window``, and its events are reduced
once the window has closed.  The raw kineto events are read directly (no
per-event Python objects are built), device events are the kernels,
copies and sets on the card, and the device is busy where the union of
their intervals lies, so overlapping streams are not counted twice.  The
benchmark's own spans and counters are read over the rest of the window,
after the profiler stopped, clear of its cost.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict

import numpy as np
import torch

WINDOW = "bench.window"
TRACE_S = 15.0
GAPS = 10
OPS = 10


def union(intervals) -> list[tuple[int, int]]:
    """Merge [start, end) intervals; the merged ones, sorted."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def gaps(busy, lo: int, hi: int) -> list[tuple[int, int]]:
    """The idle stretches of [lo, hi) between merged busy intervals."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


class Summary:
    """What one traced window holds: device time by name, busy time,
    launches and the host's operations."""

    def __init__(self, device: list, host: list, window: tuple[int, int]):
        lo, hi = window
        self.window_ns = hi - lo
        dev = [(n, s, s + d) for n, s, d in device if s + d > lo and s < hi]
        self.launches = len(dev)
        self.busy = union(clip([(s, e) for _, s, e in dev], lo, hi))
        self.busy_ns = sum(e - s for s, e in self.busy)
        self.by_name: dict[str, float] = defaultdict(float)
        for n, s, e in dev:
            self.by_name[n] += (min(e, hi) - max(s, lo)) / 1e9
        self.host_names = [n for n, _, _ in host]
        self.host_start = np.array([s for _, s, _ in host], np.int64)
        self.host_end = self.host_start + np.array([d for _, _, d in host],
                                                   np.int64)
        self.lo, self.hi = lo, hi

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    @property
    def window_s(self) -> float:
        return self.window_ns / 1e9

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_ns / self.window_ns)

    def device_seconds(self, names) -> float:
        """Device time of the events whose name holds one of ``names``."""
        return sum(v for k, v in self.by_name.items()
                   if any(n in k for n in names))

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:OPS]
        idle = sorted(gaps(self.busy, self.lo, self.hi),
                      key=lambda g: g[0] - g[1])[:GAPS]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[self._doing(a, b), (b - a) / 1e9]
                              for a, b in idle]}

    def _doing(self, a: int, b: int) -> str:
        """What the host ran during [a, b): the PyTorch operation that
        overlaps it most (the shorter one on a tie), else the benchmark's
        own span."""
        ov = (np.minimum(self.host_end, b) - np.maximum(self.host_start, a))
        best, best_key, span = None, None, None
        for i in np.flatnonzero(ov > 0):
            n = self.host_names[i]
            if n.startswith("bench."):
                if n != WINDOW:
                    span = n
                continue
            key = (int(ov[i]), -int(self.host_end[i] - self.host_start[i]))
            if best_key is None or key > best_key:
                best, best_key = n, key
        if best is not None and best_key[0] >= 0.1 * (b - a):
            return best[:160]
        return f"{span or WINDOW} (host Python, no PyTorch op)"


def _is_device(ev) -> bool:
    """A kernel, copy or set on the card; not a range that the profiler
    mirrors onto the device's timeline (``record_function``'s)."""
    if ev.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    annotation = getattr(ev, "is_user_annotation", None)
    return not (annotation is not None and annotation())


class Tracer:
    """A profiler over the first ``span_s`` seconds of the window when
    ``enabled``: it stops at the first request, step or tick boundary
    past them (``poll``), or with the window, and marks how far the run's
    counters and spans had come then.  ``finish`` reduces the trace after
    the window (``summary``); ``stretch`` and ``rest`` split the run's
    counters and spans at the mark."""

    def __init__(self, enabled: bool, span_s: float):
        self.enabled = enabled
        self.span_s = span_s
        self.summary: Summary | None = None
        self.counters: dict = {}
        self.marks: dict[str, int] = {}
        self._prof = None
        self._stopped = None

    def start(self) -> None:
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def poll(self, run) -> None:
        """At a boundary: stop once the traced stretch is long enough."""
        if self._prof is not None and (
                time.perf_counter() - self._t0 >= self.span_s):
            self.stop(run)

    def stop(self, run) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._stopped, self._prof = self._prof, None
        self._stopped.stop()
        self.counters = dict(run.counters)
        self.marks = {k: len(v) for k, v in run.spans.items()}

    def finish(self) -> None:
        """Reduce the traced stretch, once the window has closed."""
        if self._stopped is None:
            return
        prof, self._stopped = self._stopped, None
        t0 = time.perf_counter()
        self.summary = self._reduce(prof)
        print(f"trace: {self.summary.launches} device launches in "
              f"{self.summary.window_s:.1f} s, reduced in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)

    def stretch(self, run) -> tuple[dict, dict]:
        """The run's counters and spans over the traced stretch."""
        return (dict(self.counters),
                {k: list(v[:self.marks.get(k, 0)])
                 for k, v in run.spans.items()})

    def rest(self, run) -> tuple[dict, dict]:
        """The run's counters and spans over the rest of the window, after
        the profiler stopped: empty where it ran to the window's end."""
        return ({k: v - self.counters.get(k, 0)
                 for k, v in run.counters.items()},
                {k: list(v[self.marks.get(k, 0):])
                 for k, v in run.spans.items()})

    @staticmethod
    def _reduce(prof) -> Summary:
        device, host, window = [], [], None
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            if _is_device(ev):
                device.append((name, ev.start_ns(), ev.duration_ns()))
            elif ev.device_type() != torch.autograd.DeviceType.CUDA:
                if name == WINDOW:
                    window = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
                host.append((name, ev.start_ns(), ev.duration_ns()))
        if window is None:
            raise RuntimeError("the trace lost the window's range")
        # a range mirrored onto the device's timeline carries its host
        # range's name: never a kernel's
        ranges = {n for n, _, _ in host if not n.startswith(("aten::",
                                                              "cuda"))}
        device = [d for d in device if d[0] not in ranges]
        return Summary(device, host, window)
