"""The port's measurement entry points (tpuvc_torch/bench, bench_torch.py)
against the JAX repo's (bench.py, scripts/bench_harvest.py,
scripts/bench_streaming.py, scripts/compute_only.py,
scripts/bench_stages.py), on the CPU: the dispatch and drain machinery
with stub handles, the pinned ring's accounting, the inputs byte for byte,
the transfer SNRs' arithmetic against the JAX decoders, the paced
multi-stream loop on a clock of the test's own, and each entry's JSON keys
from one small CPU run of chip_smoke.py's bench phase.  The ``gpu`` tests
hold the pinned ring and its events on the card.

The module imports no JAX at top level, so that its ``gpu`` tests also run
on a machine without it:
``python -m pytest --noconftest tests/test_torch_bench.py -m gpu``.
"""

import ast
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tpuvc_torch.bench import (common, compute_only, harvest, pipelined,
                               stages, streaming, throughput)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- dispatch and drain (bench.py:43-107) ----------------------------------

class _Good:
    def result(self):
        return np.zeros(1)


class _Bad:
    def result(self):
        raise RuntimeError("copy failed")


def _run_bounded(fn, timeout_s=20.0):
    """Run fn on a daemon thread; fail the test (instead of hanging the
    suite) if it deadlocks: a drain error that left the bounded queue full
    would block the producer's q.put forever."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout_s)
    assert not th.is_alive(), "pipelined helper deadlocked"
    return box


def _ring_bad_second():
    """convert() whose results go through a pinned ring, the second one's
    copy failing: the drain discards the rest, which keep their buffers,
    so a later dispatch finds the ring full."""
    t = torch.zeros(4, dtype=torch.uint8)
    ring = pipelined.PinnedRing(t)
    n = [0]

    def convert():
        h = ring.start(t)
        n[0] += 1
        return _Bad() if n[0] == 2 else h
    return convert


@pytest.mark.parametrize("ring", [False, True])
def test_threaded_drain_surfaces_errors(ring):
    """The drain's own error reaches the caller, also when the ring it left
    full makes a later dispatch fail."""
    convert = _ring_bad_second() if ring else (lambda: _Bad())
    box = _run_bounded(
        lambda: pipelined._pipelined_threaded(convert, (), 10, 3))
    assert isinstance(box.get("error"), RuntimeError)
    assert "copy failed" in str(box["error"])


def test_threaded_drain_happy_path():
    box = _run_bounded(
        lambda: pipelined._pipelined_threaded(lambda: _Good(), (), 10, 3))
    assert "error" not in box and box["value"] > 0.0


def test_inline_pipeline_happy_path():
    box = _run_bounded(
        lambda: pipelined._pipelined_inline(lambda: _Good(), (), 10, 3))
    assert "error" not in box and box["value"] > 0.0


def test_threaded_dispatch_error_stops_the_drain():
    """A dispatch that raises ends the drain thread too, and the error
    reaches the caller."""
    calls = []

    def convert():
        calls.append(1)
        if len(calls) == 4:
            raise ValueError("dispatch failed")
        return _Good()

    before = threading.active_count()
    box = _run_bounded(lambda: pipelined._pipelined_threaded(
        convert, (), 10, 3))
    assert isinstance(box.get("error"), ValueError)
    assert threading.active_count() == before


def _checked(ring, refs, seen):
    """convert() for the strategies: the next reference tensor through
    ``ring``, its result checked against the tensor's synchronous copy."""
    i = iter(range(len(refs)))

    def convert(t):
        j = next(i)
        h = ring.start(t + j)

        class Checked:
            def result(self):
                got = h.result()
                assert np.array_equal(got, refs[j]), j
                seen.append(j)
                return got
        return Checked()
    return convert


def _ring_drive(device, k=12):
    """Every strategy over a ring of RING_SLOTS buffers: each result equals
    the synchronous copy of its tensor, and none is lost."""
    t = torch.arange(1 << 16, dtype=torch.float32, device=device)
    refs = [(t + j).cpu().numpy() for j in range(k)]
    for name, kind, depth in pipelined.STRATEGIES:
        ring = pipelined.PinnedRing(t)
        seen = []
        pipelined._FNS[kind](_checked(ring, refs, seen), (t,), k, depth)
        assert seen == list(range(k)), name
    return ring


def test_ring_serves_every_strategy_on_the_cpu():
    ring = _ring_drive(torch.device("cpu"))
    assert len(ring._bufs) == pipelined.RING_SLOTS == 5


def test_ring_refuses_to_overwrite_an_undrained_buffer():
    t = torch.zeros(4, dtype=torch.uint8)
    n = pipelined.RING_SLOTS
    ring = pipelined.PinnedRing(t)
    hs = [ring.start(t + j) for j in range(n)]
    with pytest.raises(RuntimeError, match="not drained"):
        ring.start(t + n)
    assert np.array_equal(hs[0].result(), np.zeros(4, np.uint8))
    c = ring.start(t + n)                      # the first buffer is free
    for j, h in enumerate(hs[1:], 1):
        assert np.array_equal(h.result(), np.full(4, j, np.uint8))
    assert np.array_equal(c.result(), np.full(4, n, np.uint8))
    assert np.array_equal(hs[0].result(), np.zeros(4, np.uint8))  # kept
    with pytest.raises(ValueError, match="ring holds"):
        ring.start(torch.zeros(5, dtype=torch.uint8))


# --- inputs and SNRs ---------------------------------------------------------

@pytest.mark.parametrize("overtone", [True, False])
def test_inputs_are_bench_py_bytes(overtone):
    """make_inputs against bench.py:158-170 (and compute_only.py's signal
    without the octave), restated here, at batch 3 x 0.25 s."""
    batch, dur_s, fs, sp_dim, y_dim = 3, 0.25, 16000, 513, 10
    t_samples = int(dur_s * fs)
    rng = np.random.default_rng(0)
    t = np.arange(t_samples) / fs
    if overtone:
        xs = np.stack([
            (0.3 * np.sin(2 * np.pi * (110 + 15 * i) * t)
             + 0.1 * np.sin(2 * np.pi * 2 * (110 + 15 * i) * t)
             + 0.01 * rng.standard_normal(t_samples)).astype(np.float32)
            for i in range(batch)])
    else:
        xs = np.stack([
            (0.3 * np.sin(2 * np.pi * (110 + 15 * i) * t)
             + 0.01 * rng.standard_normal(t_samples)).astype(np.float32)
            for i in range(batch)])
    y_trgs = (np.arange(batch) % y_dim).astype(np.int32)
    xmin = np.full(sp_dim, -10.0, np.float32)
    xmax = np.full(sp_dim, 1.0, np.float32)
    mu = np.full(batch, 5.0, np.float32)
    sd = np.ones(batch, np.float32)
    seeds = np.arange(batch, dtype=np.int32)
    want = (xs, y_trgs, xmin, xmax, mu, sd, mu + 0.3, sd, seeds)
    got = common.make_inputs(batch, dur_s, y_dim=y_dim, overtone=overtone)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_transfer_snrs_match_the_jax_decoders():
    """The SNR arithmetic of bench.py:243-251 on one set of codes, with the
    port's decoders and with tpuvc.ops.ulaw's: equal to 1e-6 dB."""
    from tpuvc.ops import ulaw as jax_ulaw
    from tpuvc_torch.ops import ulaw
    rng = np.random.default_rng(5)
    y = torch.tensor(np.clip(0.3 * rng.standard_normal((2, 1601)), -1, 1),
                     dtype=torch.float32)
    i16 = common.int16_encode(y).numpy()
    u8 = ulaw.ulaw_encode(y).numpy()
    p12 = ulaw.pcm12_encode(y).numpy()
    got = throughput.transfer_snrs(i16, u8, p12)
    ref = np.asarray(i16, np.float32) / 32767.0
    num = float(np.sum(ref * ref))
    dec = np.asarray(jax_ulaw.ulaw_decode(u8))
    dec12 = np.asarray(jax_ulaw.pcm12_decode(p12, n_samples=ref.shape[-1]))
    want = [10.0 * np.log10(num / max(float(np.sum((d - ref) ** 2)), 1e-20))
            for d in (dec, dec12)]
    assert abs(got[0] - want[0]) < 1e-6 and abs(got[1] - want[1]) < 1e-6
    assert 30.0 < got[0] < 45.0 and got[1] > 55.0


# --- the paced multi-stream loop --------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, d):
        assert d > 0
        self.sleeps.append(d)
        self.t += d


class _StubConverter:
    """Returns each window as its conversion; each batched call takes the
    next of ``tick_s`` on the clock."""

    device = torch.device("cpu")

    def __init__(self, clock, tick_s):
        self.clock = clock
        self.tick_s = list(tick_s)
        self.calls = 0

    def convert_batch(self, rows, srcs, trgs, seed=0, mesh=None):
        if self.calls < len(self.tick_s):
            self.clock.t += self.tick_s[self.calls]
        self.calls += 1
        return [np.asarray(r, np.float32) for r in rows]

    def convert(self, x, src, trg, seed=0, fs=None):
        return self.convert_batch([x], [src], [trg])[0]


def test_paced_loop_counts_misses_and_lags():
    """Ticks of 0.2, 0.9, 0.3, 0.1, 0.6, 0.2 s at a 0.5 s period: tick 1
    ends at 1.4 > 1.0 (miss), tick 2 starts late at 1.4 and ends at 1.7 >
    1.5 (miss: the overrun carried over), tick 3 ends at 1.8 <= 2.0, tick 4
    waits 0.2 s, ends at 2.6 > 2.5 (miss), tick 5 ends at 2.8 <= 3.0."""
    clock = _Clock()
    ticks = [0.2, 0.9, 0.3, 0.1, 0.6, 0.2]
    stub = _StubConverter(clock, [1.5, 0.4] + ticks)  # priming, throwaway
    x = np.linspace(-0.5, 0.5, 16000, dtype=np.float32)
    rec = streaming.paced_multistream(lambda c: stub, 2, 0.5, len(ticks), x,
                                      clock=clock, sleep=clock.sleep)
    assert stub.calls >= 2 + len(ticks)
    assert clock.sleeps == pytest.approx([0.3, 0.2])
    assert rec["deadline_miss_rate"] == 0.5
    assert rec["max_completion_lag_s"] == 0.9
    assert rec["p50_tick_wall_s"] == 0.25 and rec["max_tick_wall_s"] == 0.9
    assert rec["aggregate_x_realtime_at_pace"] == 4.0
    assert rec["per_stream_latency_s_p50"] == round(
        (8000 + 2 * 3040) / 16000 + 0.25, 3)
    assert rec["first_tick_s_incl_compile"] == 1.5
    assert rec["n_ticks"] == 6 and rec["paced"] is True


# --- the entries -------------------------------------------------------------

def _jax_keys(script):
    """The string keys of each dict literal in a JAX script, and those of
    the ``name["key"] = ...`` stores to each name."""
    tree = ast.parse(open(os.path.join(ROOT, script)).read())
    dicts, stores = [], {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            dicts.append({k.value for k in node.keys
                          if isinstance(k, ast.Constant)})
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and isinstance(t.slice, ast.Constant)):
                    stores.setdefault(t.value.id, set()).add(t.slice.value)
    return dicts, stores


def _holding(dicts, key):
    """The one dict literal that has ``key``."""
    (d,) = [d for d in dicts if key in d]
    return d


def _keys_of_the_jax_scripts():
    bench, out = _jax_keys("bench.py")
    harvest_, _ = _jax_keys("scripts/bench_harvest.py")
    stream, _ = _jax_keys("scripts/bench_streaming.py")
    compute, _ = _jax_keys("scripts/compute_only.py")
    _, stage = _jax_keys("scripts/bench_stages.py")
    return {"throughput": _holding(bench, "compile_wall_s") | out["out"],
            "harvest": _holding(harvest_, "refine_impl"),
            "streaming": _holding(stream, "paced_multistream"),
            "sweep": _holding(stream, "halo_s"),
            "paced": _holding(stream, "deadline_miss_rate"),
            "compute_only": _holding(compute, "s_per_call"),
            "stages": stage["results"]}


# the JAX entry points' JSON keys, read from their sources
JAX_KEYS = _keys_of_the_jax_scripts()


@pytest.fixture(scope="module")
def bench_phase():
    """chip_smoke.py's bench phase once on the CPU at a small size: the
    throughput entry at 2 x 0.5 s in "both" mode with k 2 and one
    repetition, Harvest at 1 x 0.5 s, streaming over 2 s with 2 paced
    streams, compute-only and the stages at K 1."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke.phase_bench(
        torch.device("cpu"), batch=2, harvest_batch=1, dur_s=0.5, k=2,
        reps=1, stream_s=2.0, n_streams=2, ticks=2, compute_k=1,
        stage_batch=1)


def test_throughput_entry_keys_and_snrs(bench_phase):
    rec = bench_phase["throughput"]
    assert set(rec) == JAX_KEYS["throughput"]
    assert rec["batch"] == 2 and rec["utterance_s"] == 0.5
    assert rec["encoding"] == "ulaw8" and rec["aot_cache"] is True
    assert rec["device"] == "cpu" and rec["value"] > 0
    assert set(rec["strategies"]) == {"inline_d2", "inline_d3",
                                      "threaded_d3"}
    assert rec["strategy"] in rec["strategies"]
    for enc in ("int16", "pcm12"):
        assert set(rec[enc]) == {"best", "strategy", "x_realtime",
                                 "vs_baseline", "detail"}
    assert np.isfinite(rec["ulaw_snr_db"]) and np.isfinite(
        rec["pcm12_snr_db"])
    assert rec["ulaw_snr_db"] >= 30.0 and rec["pcm12_snr_db"] >= 50.0


def test_harvest_and_streaming_entry_keys(bench_phase):
    rec = bench_phase["harvest"]
    assert set(rec) == JAX_KEYS["harvest"]
    assert rec["harmonics_impl"] == rec["refine_impl"] == "plain"
    rec = bench_phase["streaming"]
    assert set(rec) == JAX_KEYS["streaming"]
    assert [set(r) for r in rec["sweep"]] == [JAX_KEYS["sweep"]]
    assert [set(r) for r in rec["paced_multistream"]] == [JAX_KEYS["paced"]]
    assert rec["paced_multistream"][0]["n_streams"] == 2


def test_compute_only_and_stage_entry_keys(bench_phase):
    for impl, rec in bench_phase["compute_only"].items():
        assert set(rec) == JAX_KEYS["compute_only"]
        assert rec["d2s_impl"] == impl
        assert rec["s_per_call"] > 0
    rec = bench_phase["stages"]
    assert set(rec["results"]) == JAX_KEYS["stages"]
    r = rec["results"]
    assert rec["sum (gd)"] == pytest.approx(
        sum(r.values()) - r["d4c_nccf"] - r["excitation"])
    assert "syncs" not in bench_phase             # counted on the card only


def test_chip_smoke_lists_the_jax_keys():
    sys.path.insert(0, ROOT)
    import chip_smoke
    assert chip_smoke.BENCH_KEYS == JAX_KEYS
    assert JAX_KEYS["throughput"] >= {"compile_wall_s", "aot_cache",
                                      "int16", "pcm12"}


def test_entries_refuse_a_machine_without_a_card(monkeypatch):
    """Every entry defaults to the card and raises without one, before
    building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (throughput.measure, harvest.measure, streaming.run,
                compute_only.measure, stages.measure):
        with pytest.raises(RuntimeError, match="CUDA card"):
            run()


def test_bench_torch_cli():
    """bench_torch.py takes bench.py's arguments: an unknown encoding gets
    bench.py's message, and without a card it exits non-zero."""
    with pytest.raises(SystemExit, match=(
            r"unknown encoding 'mp3'; expected ulaw8 \| pcm12 \| int16 \| "
            "both")):
        throughput.main(["8", "1", "mp3"])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned ring's copies and "
                    "events exist only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ring_on_the_card_matches_synchronous_copies(cuda):
    """Through each strategy (depth 2 and 3) the pinned ring's results equal
    a synchronous .cpu() of the same tensors, in order, none overwritten
    before it was drained; the buffers are pinned."""
    ring = _ring_drive(cuda, k=16)
    assert all(b.is_pinned() for b in ring._bufs)


@pytest.mark.gpu
def test_ring_copy_waits_for_the_producing_kernel(cuda):
    """A result queued behind a long kernel on the stream is the kernel's
    output: the event is recorded after the copy, and result() waits on
    it."""
    a = torch.randn(2048, 2048, device=cuda)
    ring = pipelined.PinnedRing(a)
    handles, refs = [], []
    for j in range(pipelined.RING_SLOTS):
        y = a
        for _ in range(8):
            y = y @ a * 1e-3 + j
        handles.append(ring.start(y))
        refs.append(y)
    for h, y in zip(handles, refs):
        assert np.array_equal(h.result(), y.cpu().numpy())
