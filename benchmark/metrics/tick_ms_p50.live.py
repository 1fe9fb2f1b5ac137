"""Median over the window's ticks of one tick's pushes, from its start to
its end (the benchmark's span ``bench.tick``)."""

from benchmark.readers import span_median_ms


def read(run):
    return span_median_ms(run, "bench.tick")
