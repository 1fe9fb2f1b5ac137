"""The arithmetic the metrics rest on."""

import math
import time

import numpy as np
import pytest

from benchmark import flops, peaks, trace
from benchmark.drivers import corpus, live
from benchmark.reference.arch import Architecture, NetSpec
from benchmark.run import Run
from benchmark.tests import small


def test_union_merges_overlaps_and_gaps_fill_the_rest():
    u = trace.union([(5, 9), (0, 3), (2, 4), (8, 12), (20, 21)])
    assert u == [(0, 4), (5, 12), (20, 21)]
    assert trace.gaps(u, -2, 25) == [(-2, 0), (4, 5), (12, 20), (21, 25)]
    assert trace.clip(u, 1, 6) == [(1, 4), (5, 6)]


def test_summary_counts_busy_time_once_where_streams_overlap():
    dev = [("k1", 0, 400), ("k2", 100, 200), ("Memcpy HtoD", 600, 100),
           ("k1", 1500, 100)]
    host = [("bench.window", 0, 1000), ("aten::add", 700, 250),
            ("bench.request", 0, 1000)]
    s = trace.Summary(dev, host, (0, 1000))
    assert s.busy_ns == 500 and s.launches == 3
    assert s.idle_pct() == pytest.approx(50.0)
    assert s.device_seconds(["k1"]) == pytest.approx(400e-9)
    b = s.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(400e-9)]
    assert b["idle_gaps"][0][0] == "aten::add"
    assert b["idle_gaps"][0][1] == pytest.approx(300e-9)


def test_the_live_tail_is_over_every_chunk_and_failures_are_infinite():
    lags = [0.1] * 90 + [0.2] * 9 + [math.inf]
    assert live.tail(lags, 0.95) == 0.2
    assert live.tail(lags + [math.inf] * 5, 0.95) == math.inf
    assert live.tail([0.3], 0.95) == 0.3
    assert live.tail(list(range(1, 101)), 0.95) == 95


class _SlowConverter:
    """A converter whose every call takes ``dt`` seconds."""

    def __init__(self, dt):
        self.dt = dt

    def convert_batch(self, xs, srcs, trgs, seed=0):
        time.sleep(self.dt)
        return [np.asarray(x) for x in xs]


def test_the_rate_is_over_the_whole_window_with_the_last_request(monkeypatch):
    run = Run("vawgan-vcc2016.corpus", 5, "cpu", small.CORPUS)
    cell = corpus.Cell(run)
    monkeypatch.setattr(corpus, "make_converter",
                        lambda *a, **k: _SlowConverter(0.05))
    cell.setup()
    t0 = time.perf_counter()
    cell.window(0.12)
    took = time.perf_counter() - t0
    n = run.counters["requests"]
    assert n == run.attempted == 3          # the one in flight finishes
    real = sum(float(cell.pool.lengths[r].sum()) for r, *_ in cell.done)
    assert run.counters["audio_s"] == pytest.approx(real / 16000)
    rate = run.end_to_end["audio_s_per_s"]
    assert rate == pytest.approx(real / 16000 / run.counters["window_s"])
    assert run.counters["window_s"] <= took


def test_stream_geometry_is_the_converters():
    world = corpus.ref.World()
    t = {"chunk_s": 0.25, "halo_s": 0.192}
    assert live.stream_geometry(t, world) == (4000, 3040)
    assert live.stream_geometry({"chunk_s": 0.25, "halo_s": 0.05},
                                world) == (4000, 2000)


def test_flops_against_a_hand_count():
    a = Architecture(x_dim=27, z_dim=2, y_dim=3, y_emb_dim=2,
                     encoder=NetSpec((3, 3), (3, 3), (2, 4)),
                     generator=NetSpec((3, 3), (3, 1), (4, 1)),
                     discriminator=NetSpec((3,), (3,), (2,)),
                     d_conditional=True)
    # encoder: 27 -> 9 x 2 (2*3*1*2*9), 9 -> 3 x 4 (2*3*2*4*3); heads 2 x
    # (2 * 12 * 2)
    assert flops.encoder_per_frame(a) == 108 + 144 + 96
    # decoder: dense (2+2) -> 19*4: 2*4*76; conv 4 -> 4*3 at 19: 2*3*4*12*19;
    # depth to space -> 57 x 4; conv 4 -> 1 at 57: 2*3*4*1*57
    assert flops.decoder_per_frame(a) == 608 + 5472 + 1368
    # critic: 27 -> 9 x 2: 108; score 2*18; projection 2*18*2
    assert flops.critic_per_frame(a) == 108 + 36 + 72
    t = a.training
    fg = t.batch_size * (348 + 7448)
    fc = t.batch_size * 216
    assert flops.vawgan_step(a) == t.n_unroll * (fg + 12 * fc) + 3 * fg + 2 * fc


def test_the_published_generator_is_about_56_mflop_per_frame():
    cfg = corpus.ref_arch.Architecture.load(
        __file__.rsplit("/benchmark/", 1)[0]
        + "/configs/architecture-vawgan-vcc2016.json")
    assert 50e6 < flops.generator_per_frame(cfg) < 60e6
    assert peaks.bound_s(3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12, 495e12) == pytest.approx(2.0)


class _Counting:
    """What a driver keeps: counters and spans brought up to date at each
    boundary."""

    def __init__(self):
        self.counters, self.spans = {}, {"bench.tick": []}

    def tick(self, n, wall):
        self.spans["bench.tick"].append(wall)
        self.counters.update(ticks=n, window_s=0.1 * n)


def test_the_programs_spans_are_read_after_the_profiler():
    run = _Counting()
    tr = trace.Tracer(True, 0.0)
    tr.start()
    for n in (1, 2):
        run.tick(n, 0.5)
    tr.poll(run)                        # the traced stretch ends here
    for n in (3, 4, 5):
        run.tick(n, 0.2)
    tr.stop(run)                        # the window closes: already stopped
    tr.finish()
    assert tr.summary is not None and tr.summary.window_s > 0
    counters, spans = tr.stretch(run)
    assert counters == {"ticks": 2, "window_s": pytest.approx(0.2)}
    assert spans == {"bench.tick": [0.5, 0.5]}
    counters, spans = tr.rest(run)
    assert counters == {"ticks": 3, "window_s": pytest.approx(0.3)}
    assert spans == {"bench.tick": [0.2, 0.2, 0.2]}
    from benchmark import readers
    run.counters, run.spans = counters, spans
    assert readers.find("tick_ms_p50.live")(run) == pytest.approx(200.0)


def test_a_profiler_that_runs_to_the_end_leaves_no_rest():
    run = _Counting()
    tr = trace.Tracer(True, 1e9)
    tr.start()
    run.tick(1, 0.5)
    tr.poll(run)
    tr.stop(run)
    tr.finish()
    counters, spans = tr.rest(run)
    assert spans == {"bench.tick": []} and counters["ticks"] == 0
