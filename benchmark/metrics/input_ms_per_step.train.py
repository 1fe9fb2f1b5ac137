"""Milliseconds per step spent in ``next()`` of the batch iterator the
trainer is fed (the benchmark's span ``bench.input``)."""

from benchmark.readers import span_per


def read(run):
    return span_per(run, "bench.input", "steps")
