"""Host milliseconds of the streaming surface per ``vc.tick`` of the
traced stretch: the program's ``vc.push`` spans less the ticks nested in
them, plus each tick's ``vc.tick_rows`` (gathering its rows and seeds) and
``vc.tick_emit`` (the per-stream crossfades and queues)."""

from benchmark import spans


def _host_ns(s) -> int:
    return (spans.host_ns(s, "vc.push") - spans.nested_ns(s, spans.TICK,
                                                          "vc.push")
            + spans.host_ns(s, "vc.tick_rows", "vc.tick_emit"))


def read(run):
    return spans.per_root(run.summary, spans.TICK,
                          lambda s: _host_ns(s) / 1e6)
