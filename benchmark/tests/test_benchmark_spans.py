"""The readers of the program's own spans and counters, on hand-made
traces."""

import sys
import types

import pytest

from benchmark import readers, spans, trace

NEW = ("f0_idle_ms_per_call.corpus", "f0_idle_ms_per_call.live",
       "prep_ms_per_call.corpus", "prep_ms_per_call.live",
       "syncs_per_call.corpus", "stream_host_ms_per_tick.live")

# the card busy over [100, 200), [300, 350) and [600, 700) of [0, 1000)
DEVICE = [("k1", 100, 100), ("k2", 300, 50), ("Memcpy HtoD", 600, 100)]


def _summary(host, device=DEVICE) -> trace.Summary:
    return trace.Summary(device, [("bench.window", 0, 1000)] + host,
                         (0, 1000))


def _run(summary) -> types.SimpleNamespace:
    return types.SimpleNamespace(summary=summary, counters={}, spans={})


def _read(name, summary):
    return readers.find(name)(_run(summary))


# two calls; the first in two chunks, whose world.f0 spans are adjacent,
# with one more world.f0 nested inside the first (a shard thread's)
CORPUS = [
    ("vc.convert_batch", 50, 400), ("vc.prep", 50, 10),
    ("world.f0", 60, 190), ("world.f0", 100, 50), ("dio_contour", 150, 100),
    ("vc.prep", 250, 0), ("world.f0", 250, 70), ("vc.upload", 320, 30),
    ("cudaStreamSynchronize", 330, 5), ("vc.noise", 400, 40),
    ("vc.convert_batch", 500, 450), ("vc.prep", 500, 20),
    ("world.f0", 520, 130), ("cuStreamSynchronize", 700, 1),
    ("cudaDeviceSynchronize", 980, 1), ("aten::copy_", 960, 30)]


def test_idle_inside_a_span_counts_nested_and_adjacent_spans_once():
    s = _summary(CORPUS)
    # union [60, 320) holds busy [100, 200) and [300, 320): idle 140;
    # [520, 650) holds busy [600, 650): idle 80
    assert spans.idle_ns_inside(s, "world.f0") == 140 + 80
    assert spans.idle_ns_inside(s, "dio_contour") == 50
    assert spans.idle_ns_inside(s, "no.such.span") == 0
    assert spans.count(s, "vc.convert_batch") == 2
    assert _read("f0_idle_ms_per_call.corpus", s) == pytest.approx(110e-6)
    assert _read("f0_idle_ms_per_call.live", s) == pytest.approx(110e-6)


def test_host_time_is_per_root_call():
    s = _summary(CORPUS)
    assert spans.host_ns(s, "vc.prep", "vc.upload", "vc.noise") == 100
    assert _read("prep_ms_per_call.corpus", s) == pytest.approx(50e-6)


def test_syncs_count_inside_the_calls_only():
    s = _summary(CORPUS)
    assert spans.count(s, spans.SYNC) == 3
    assert spans.count_inside(s, spans.SYNC, spans.CALL) == 2
    assert _read("syncs_per_call.corpus", s) == pytest.approx(1.0)


def test_the_push_spans_less_their_ticks_per_tick():
    """Two ticks of three pushes each: the last push of each holds the
    tick; the pushes' own time, the rows and the crossfades are the
    streaming surface's."""
    host = []
    for t0 in (0, 500):
        host += [("vc.push", t0, 10), ("vc.push", t0 + 10, 10),
                 ("vc.push", t0 + 20, 380), ("vc.tick", t0 + 30, 360),
                 ("vc.tick_rows", t0 + 30, 10),
                 ("vc.convert_batch", t0 + 40, 330),
                 ("vc.tick_emit", t0 + 370, 20)]
    s = _summary(host)
    assert spans.nested_ns(s, spans.TICK, "vc.push") == 720
    # (400 - 360) of pushes + 10 + 20 a tick
    assert _read("stream_host_ms_per_tick.live", s) == pytest.approx(70e-6)
    assert _read("prep_ms_per_call.live", s) == 0.0


def test_spans_outside_the_window_are_left_out():
    s = trace.Summary(DEVICE, [("bench.window", 0, 1000),
                               ("vc.convert_batch", 1200, 50),
                               ("vc.convert_batch", 10, 50),
                               ("vc.prep", 1200, 40)], (0, 1000))
    assert spans.count(s, spans.CALL) == 1
    assert spans.host_ns(s, "vc.prep") == 0


@pytest.mark.parametrize("name", NEW)
def test_no_device_events_or_no_root_reads_none(name):
    assert _read(name, None) is None
    assert _read(name, _summary(CORPUS, device=[])) is None   # the CPU
    assert _read(name, _summary([("hv_contour", 10, 20)])) is None


def test_the_padding_share_reads_the_programs_counters(monkeypatch):
    pipeline = types.ModuleType("tpuvc_torch.convert.pipeline")
    monkeypatch.setitem(sys.modules, pipeline.__name__, pipeline)
    for name in ("useful_samples_pct.corpus", "useful_samples_pct.live"):
        assert _read(name, None) is None     # a program without them
    pipeline.samples_real, pipeline.samples_analysed = 0, 0
    assert _read("useful_samples_pct.corpus", None) is None
    pipeline.samples_real, pipeline.samples_analysed = 234, 384
    assert _read("useful_samples_pct.live", None) == pytest.approx(
        100 * 234 / 384)
