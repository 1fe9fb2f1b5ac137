"""Pipelined dispatch of device calls, the port of ``bench.py:43-107``.

JAX overlaps a call's device-to-host copy with the next dispatches through
``copy_to_host_async()`` and ``np.asarray``.  Here a call's result goes
through a ``PinnedRing``: ``start`` copies the device tensor into a pinned
host buffer with ``non_blocking=True`` and records a CUDA event after the
copy; the returned ``HostCopy.result()`` waits on that event and returns
the numpy array.  The strategies take ``convert(*args)`` returning such a
handle (anything with ``result()``).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

# name, strategy, depth (results in flight before the oldest is drained)
STRATEGIES = (("inline_d2", "inline", 2), ("inline_d3", "inline", 3),
              ("threaded_d3", "threaded", 3))
# buffers a ring needs for every strategy: at a copy's start, ``depth``
# results wait in the queue and the drain thread holds one more
RING_SLOTS = max(d for _, _, d in STRATEGIES) + 2


class HostCopy:
    """One device result on its way into a ring's host buffer."""

    def __init__(self, ring: "PinnedRing", slot: int, event):
        self._ring = ring
        self._slot = slot
        self._event = event
        self._value: np.ndarray | None = None

    def result(self) -> np.ndarray:
        """Wait for the copy, and return the result as a numpy array of its
        own; the buffer goes back to the ring."""
        if self._value is None:
            if self._event is not None:
                self._event.synchronize()
            self._value = self._ring._bufs[self._slot].numpy().copy()
            self._ring._release(self._slot)
        return self._value


class PinnedRing:
    """``RING_SLOTS`` host buffers shaped as ``like``, used in turn; pinned
    when ``like`` is on the card, so that the copy into them is
    asynchronous.  Allocate it once, outside a timed loop.  Starting a copy
    into a buffer whose result has not been drained raises: no copy
    overwrites one."""

    def __init__(self, like: torch.Tensor):
        self._pinned = like.is_cuda
        self._bufs = [torch.empty(like.shape, dtype=like.dtype,
                                  pin_memory=self._pinned)
                      for _ in range(RING_SLOTS)]
        self._busy = [False] * RING_SLOTS
        self._next = 0
        self._lock = threading.Lock()

    def start(self, t: torch.Tensor) -> HostCopy:
        """Copy ``t`` into the next buffer; returns its handle."""
        like = self._bufs[0]
        if t.shape != like.shape or t.dtype != like.dtype:
            raise ValueError(f"ring holds {tuple(like.shape)} {like.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        with self._lock:
            slot = self._next
            if self._busy[slot]:
                raise RuntimeError(
                    f"pinned ring: buffer {slot} of {len(self._bufs)} is "
                    "not drained yet (more results in flight than buffers)")
            self._busy[slot] = True
            self._next = (slot + 1) % len(self._bufs)
        self._bufs[slot].copy_(t, non_blocking=self._pinned)
        event = None
        if t.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(t.device))
        return HostCopy(self, slot, event)

    def _release(self, slot: int) -> None:
        with self._lock:
            self._busy[slot] = False


def primed(call, args):
    """``call`` wrapped to copy each result into a pinned ring sized by one
    call's result; returns (wrapped call, that first call's handle)."""
    y = call(*args)
    ring = PinnedRing(y)
    return (lambda *a: ring.start(call(*a))), ring.start(y)


def _pipelined_inline(convert, args, k: int, depth: int) -> float:
    """Dispatch with an inline bounded queue; returns wall s/call."""
    t0 = time.perf_counter()
    pending = []
    for _ in range(k):
        pending.append(convert(*args))
        if len(pending) > depth:
            pending.pop(0).result()
    for h in pending:
        h.result()
    return (time.perf_counter() - t0) / k


def _pipelined_threaded(convert, args, k: int, depth: int) -> float:
    """Dispatch on this thread, drain on a worker thread: the waits on
    finished copies overlap the next dispatches."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []

    def drain():
        # After an error, keep CONSUMING the queue (discarding items) until
        # the sentinel: returning early would leave the bounded queue full
        # and deadlock the producer's q.put forever.
        failed = False
        while True:
            h = q.get()
            if h is None:
                return
            if failed:
                continue
            try:
                h.result()
            except BaseException as e:   # surfaced on the caller's thread
                err.append(e)
                failed = True

    th = threading.Thread(target=drain, daemon=True)
    t0 = time.perf_counter()
    th.start()
    try:
        for _ in range(k):
            q.put(convert(*args))      # blocks at depth outstanding
    except BaseException:
        # A drain error comes first: the results it discards keep their
        # ring buffers, so the next dispatch fails on a full ring.
        if not err:
            raise
    finally:                           # a failed dispatch stops the drain too
        q.put(None)
        th.join()
    if err:
        raise err[0]
    return (time.perf_counter() - t0) / k


_FNS = {"inline": _pipelined_inline, "threaded": _pipelined_threaded}


def _measure(convert, args, k: int, reps: int):
    """Median wall s/call for each strategy; returns (best, detail)."""
    detail = {}
    for name, kind, depth in STRATEGIES:
        times = sorted(_FNS[kind](convert, args, k, depth)
                       for _ in range(reps))
        detail[name] = {"median": round(times[len(times) // 2], 4),
                        "spread": [round(times[0], 4), round(times[-1], 4)]}
    best_name = min(detail, key=lambda n: detail[n]["median"])
    return best_name, detail
