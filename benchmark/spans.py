"""The program's own stage spans in a traced stretch, and the arithmetic of
the per-layer metrics that read them.

The port opens ``torch.profiler.record_function`` ranges at its stage
boundaries while a profiler records (``tpuvc_torch/utils/profiling.py``):
``vc.convert_batch`` around a call, its stages (``vc.prep``,
``vc.upload``, ``vc.noise``, ``world.f0`` with DIO's or Harvest's own,
``world.sp``, ``world.ap``, ``vc.model``, ``vc.synth``, ``vc.fetch``), and
the streaming tick's (``vc.push``, ``vc.tick``, ``vc.tick_rows``,
``vc.tick_emit``).  They are kineto host events on the clock of the
device's events, so everything here reads ``trace.Summary``: its merged
busy intervals, and its host events' names, starts and ends.  A metric is
taken per root span of the program in the stretch (one
``vc.convert_batch`` per call, one ``vc.tick`` per tick), never per
counter of the benchmark, and reads None where the trace holds no device
events (a run on the CPU) or no root (a program without the spans).
"""

from __future__ import annotations

import functools
from collections import defaultdict

import numpy as np

from benchmark import trace

CALL = "vc.convert_batch"
TICK = "vc.tick"
# the suffix of the host's waits for the card in the CUDA API, at either
# level (cudaStreamSynchronize, ..., cuStreamSynchronize, ...)
SYNC = "Synchronize"
_NONE = np.zeros(0, np.int64)


@functools.lru_cache(maxsize=1)
def _index(summary: trace.Summary) -> dict[str, np.ndarray]:
    """The host events that start inside the traced window, by name; those
    whose name ends in ``SYNC`` also under ``SYNC``."""
    inside = np.flatnonzero((summary.host_start >= summary.lo)
                            & (summary.host_start < summary.hi))
    names = summary.host_names
    by: dict[str, list[int]] = defaultdict(list)
    for i in inside.tolist():
        n = names[i]
        by[n].append(i)
        if n.endswith(SYNC):
            by[SYNC].append(i)
    return {k: np.asarray(v, np.int64) for k, v in by.items()}


def intervals(summary: trace.Summary, name: str
              ) -> tuple[np.ndarray, np.ndarray]:
    """Starts and ends (ns) of the host events ``name`` in the stretch, in
    the order they started."""
    idx = _index(summary).get(name, _NONE)
    order = np.argsort(summary.host_start[idx], kind="stable")
    idx = idx[order]
    return summary.host_start[idx], summary.host_end[idx]


def count(summary: trace.Summary, name: str) -> int:
    return len(_index(summary).get(name, _NONE))


def host_ns(summary: trace.Summary, *names: str) -> int:
    """The host's time inside the spans ``names``, summed."""
    return int(sum(int(np.sum(e - s)) for s, e in
                   (intervals(summary, n) for n in names)))


def _busy_before(summary: trace.Summary, t: np.ndarray) -> np.ndarray:
    """The card's busy time before each instant of ``t`` (ns)."""
    if not summary.busy:
        return np.zeros(len(t), np.int64)
    bs, be = (np.array(v, np.int64) for v in zip(*summary.busy))
    before = np.concatenate([[0], np.cumsum(be - bs)])
    k = np.searchsorted(bs, t, side="right")
    j = np.maximum(k - 1, 0)
    part = np.minimum(t, be[j]) - bs[j]
    return np.where(k > 0, before[j] + part, 0)


def idle_ns_inside(summary: trace.Summary, name: str) -> int:
    """The card's idle time while the host was inside a span ``name``:
    the union of those spans (nested or overlapping ones counted once),
    less the card's busy time inside it."""
    s, e = intervals(summary, name)
    merged = trace.clip(trace.union(zip(s.tolist(), e.tolist())),
                        summary.lo, summary.hi)
    if not merged:
        return 0
    a, b = (np.array(v, np.int64) for v in zip(*merged))
    busy = _busy_before(summary, b) - _busy_before(summary, a)
    return int(np.sum(b - a) - np.sum(busy))


def _within(summary: trace.Summary, t: np.ndarray, outer: str) -> np.ndarray:
    """Which instants of ``t`` lie inside a span ``outer``."""
    s, e = intervals(summary, outer)
    merged = trace.union(zip(s.tolist(), e.tolist()))
    if not merged:
        return np.zeros(len(t), bool)
    s, e = (np.array(v, np.int64) for v in zip(*merged))
    j = np.searchsorted(s, t, side="right") - 1
    return (j >= 0) & (t < e[np.maximum(j, 0)])


def count_inside(summary: trace.Summary, name: str, outer: str) -> int:
    """How many host events ``name`` (or, for ``SYNC``, whose name ends
    in it) start inside a span ``outer``."""
    s, _ = intervals(summary, name)
    return int(np.sum(_within(summary, s, outer)))


def nested_ns(summary: trace.Summary, inner: str, outer: str) -> int:
    """The host's time in the spans ``inner`` that start inside a span
    ``outer``."""
    s, e = intervals(summary, inner)
    return int(np.sum((e - s)[_within(summary, s, outer)]))


def per_root(summary: trace.Summary | None, root: str, value):
    """``value(summary)`` over the number of root spans ``root`` in the
    stretch; None where the trace holds no device events or no root."""
    if summary is None or summary.launches == 0:
        return None
    n = count(summary, root)
    return None if n == 0 else value(summary) / n
