"""The per-layer readers, found by the metric's name, and their shared
arithmetic.

A reader gets the run (its trace summary, counters, spans and roofline
recorder) and returns a number, or None where it finds nothing to read:
the metric is then left out of the result line.
"""

from __future__ import annotations

import os
import statistics

from benchmark import common, flops, kernels, peaks
from benchmark.drivers.corpus import architecture


def find(name: str):
    """The reader of per-layer metric ``name``.  ``<kernel>_roofline`` is
    the share of the kernel counted in ``roofline/<kernel>.py``
    (``kernels_roofline``: of every kernel there); any other name is read
    by ``metrics/<name>.py`` or, for ``<stem>.<suffix>``, by
    ``metrics/<stem>.py``, so one reader serves a quantity in every kind
    of cell."""
    if name.endswith(kernels.SUFFIX):
        kernel = name[:-len(kernels.SUFFIX)]
        if kernel != kernels.ALL:
            common.load_module("roofline", kernel)     # the count must exist
        return lambda run: roofline(run, None if kernel == kernels.ALL
                                    else kernel)
    for stem in (name, name.split(".", 1)[0]):
        if os.path.exists(os.path.join(common.BENCH, "metrics",
                                       f"{stem}.py")):
            return common.load_module("metrics", stem).read
    raise FileNotFoundError(f"no reader of the metric {name!r}")


def idle_pct(run):
    s = run.summary
    return None if s is None or s.busy_ns == 0 else s.idle_pct()


def roofline(run, kernel):
    rec = run.roofline
    if rec is None:
        return None
    return rec.share(run.summary, run.counters.get("requests", 0), kernel)


def per_count(run, counter):
    """Device launches (kernels, copies, sets) in the window per unit of
    ``counter``."""
    s, n = run.summary, run.counters.get(counter, 0)
    return None if s is None or s.launches == 0 or not n else s.launches / n


def mfu(run, ops, peak):
    s = run.summary
    if s is None or s.busy_ns == 0 or not ops:
        return None
    return 100.0 * ops / (s.window_s * peak)


def serve_mfu(run):
    arch = architecture(run.config, "serve_dtype")
    return mfu(run, run.counters.get("frames", 0)
               * flops.generator_per_frame(arch), peaks.BF16_OPS_PER_S)


def train_mfu(run):
    arch = architecture(run.config, "train_dtype")
    return mfu(run, run.counters.get("steps", 0) * flops.vawgan_step(arch),
               peaks.TF32_OPS_PER_S)


def span_per(run, span, counter):
    """Milliseconds of the benchmark's span ``span`` per ``counter``."""
    v, n = run.spans.get(span), run.counters.get(counter, 0)
    return None if not v or not n else 1e3 * sum(v) / n


def span_median_ms(run, span):
    v = run.spans.get(span)
    return None if not v else 1e3 * statistics.median(v)
