"""Roofline shares of the hand kernels, counted from the algorithm.

Each ``roofline/<kernel>.py`` names the device kernels it covers
(``DEVICE_NAMES``), the reference stage whose inputs are the kernel's
(``REFERENCE``: ``module.function`` under ``reference/``) and
``work(...) -> (bytes, float32 ops, TF32 ops)`` over those inputs.
While the reference checks the sampled requests, every call of those
stages is counted, so the count reads the work the request needs,
whatever implements it in the program.  A kernel's share is the least
time its work needs on the card, per request, times the requests of the
traced window, over the device time of its kernels in that window.
"""

from __future__ import annotations

import contextlib
import importlib
from collections import defaultdict

import torch

from benchmark import common, peaks

SUFFIX = "_roofline"
ALL = "kernels"          # the metric over every kernel: kernels_roofline


class Recorder:
    def __init__(self, names: list[str]):
        self.mods = {n: common.load_module("roofline", n) for n in names}
        self.bound_s: dict[str, float] = defaultdict(float)
        self.requests = 0

    @staticmethod
    def for_metrics(metric_names: list[str]) -> "Recorder | None":
        """A recorder of the kernels the cell's metrics name (all of them
        for ``kernels_roofline``), or None."""
        wanted = [m[:-len(SUFFIX)] for m in metric_names
                  if m.endswith(SUFFIX)]
        if not wanted:
            return None
        names = (common.names("roofline", ".py") if ALL in wanted
                 else wanted)
        return Recorder(names)

    @contextlib.contextmanager
    def recording(self):
        """Count the work of every covered reference stage called inside."""
        saved = []
        for name, mod in self.mods.items():
            for site in mod.REFERENCE:
                mname, fname = site.rsplit(".", 1)
                target = importlib.import_module(f"benchmark.reference.{mname}")
                fn = getattr(target, fname)
                saved.append((target, fname, fn))
                setattr(target, fname, self._wrap(name, mod, fn))
        try:
            yield
        finally:
            for target, fname, fn in saved:
                setattr(target, fname, fn)

    def _wrap(self, name, mod, fn):
        def counted(*args, **kwargs):
            out = fn(*args, **kwargs)
            with torch.no_grad():
                b, ops, tf32 = mod.work(*args, **kwargs, out=out)
            self.bound_s[name] += peaks.bound_s(b, ops, tf32)
            return out
        return counted

    def share(self, summary, window_requests: int, kernel: str | None
              ) -> float | None:
        """Percent of the roofline of ``kernel`` (all kernels with None)
        in the traced window; None where nothing was counted or ran."""
        if summary is None or not self.requests or not window_requests:
            return None
        names = list(self.mods) if kernel is None else [kernel]
        names = [n for n in names if n in self.mods and self.bound_s[n] > 0]
        if not names:
            return None
        bound = sum(self.bound_s[n] for n in names) / self.requests
        dev = summary.device_seconds(
            [d for n in names for d in self.mods[n].DEVICE_NAMES])
        if dev <= 0:
            return None
        return 100.0 * bound * window_requests / dev
