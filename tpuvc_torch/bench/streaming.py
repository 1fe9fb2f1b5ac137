"""The streaming serving surface on the card: the port of
``scripts/bench_streaming.py``.

Drives ``convert/streaming.py``'s ``StreamingConverter`` and
``MultiStreamConverter`` over the full-width model (bf16, seeded random
weights, ulaw8 drain) with real per-chunk device calls:

  - single stream: per-chunk wall time (median / p90, first chunk
    dropped), throughput, latency (buffered audio + chunk wall)
  - multi-stream: a real-time-paced tick loop per (chunk, streams)
    config: tick k is due at T0 + k * chunk_s, the loop sleeps until then
    (an overrun carries over: the next tick starts late), and a tick
    misses its deadline when it completes after due + chunk_s (the
    playback buffer would underrun).  p50/p90/p99 tick walls, the miss
    rate and the largest completion lag.

    python -m tpuvc_torch.bench.streaming [CHUNK ...] [--streams 4,8,16]
        [--paced-chunks 0.5,1.0] [--ticks 100] [--skip-single]
        [--skip-paced] [--device cuda]

Prints each result as a JSON line as it comes, then one JSON line with
them all (the JAX script's keys).  The clock and the sleep are arguments
of the loops, so that a test can run them on a clock of its own.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from tpuvc_torch.bench import common
from tpuvc_torch.convert.pipeline import Converter, ConverterAssets
from tpuvc_torch.convert.streaming import (MultiStreamConverter,
                                           StreamingConverter)
from tpuvc_torch.dsp.constants import DEFAULT_WORLD
from tpuvc_torch.ops._build import reset_counts
from tpuvc_torch.utils.device import resolve


def signal(cfg=DEFAULT_WORLD, dur_s: float = 30.0) -> np.ndarray:
    """The JAX script's test signal: 120 Hz and its octave, light noise."""
    rng = np.random.default_rng(0)
    t = np.arange(int(dur_s * cfg.fs)) / cfg.fs
    return (0.3 * np.sin(2 * np.pi * 120 * t)
            + 0.1 * np.sin(2 * np.pi * 240 * t)
            + 0.01 * rng.standard_normal(t.shape[0])).astype(np.float32)


def converter_factory(device, cfg=DEFAULT_WORLD):
    """chunk_s -> a ulaw8 ``Converter`` bucketed at chunk_s over one seeded
    full-width model on ``device``, with the JAX script's assets."""
    model, _ = common.seeded_model(device)
    assets = ConverterAssets(
        xmin=np.full(cfg.sp_dim, -10.0, np.float32),
        xmax=np.full(cfg.sp_dim, 1.0, np.float32),
        f0_mu=np.array([5.0, 5.3], np.float32),
        f0_sigma=np.ones(2, np.float32),
        speakers=["S0", "S1"])
    return lambda chunk_s: Converter(model, assets, cfg, bucket_s=chunk_s,
                                     transfer_encoding="ulaw8",
                                     device=device)


def single_stream_sweep(make_conv, chunks, x, cfg=DEFAULT_WORLD,
                        clock=time.perf_counter) -> list:
    """One stream per chunk size, fed one chunk per push."""
    results = []
    for chunk_s in chunks:
        conv = make_conv(chunk_s)
        s = StreamingConverter(conv, "S0", "S1", chunk_s=chunk_s, cfg=cfg)
        window = s.chunk + 2 * s.halo
        reset_counts()
        t0 = clock()                        # warm up on the window's shape
        conv.convert(x[:window], "S0", "S1")
        compile_s = clock() - t0
        common.require_launches(common.DIO_KERNELS, conv.device,
                                "bench streaming")

        walls = []
        fed = 0
        feed = s.chunk                      # one chunk per push
        t_start = clock()
        while fed + feed <= len(x):
            t0 = clock()
            out = s.push(x[fed: fed + feed])
            if out.size:                    # a real device call happened
                walls.append(clock() - t0)
            fed += feed
        s.flush()
        total = clock() - t_start
        walls = np.array(walls[1:])         # drop the first
        med = float(np.median(walls))
        buffered_s = window / cfg.fs
        results.append({
            "chunk_s": chunk_s,
            "halo_s": round(s.halo / cfg.fs, 3),
            "median_chunk_wall_s": round(med, 4),
            "p90_chunk_wall_s": round(float(np.percentile(walls, 90)), 4),
            "stream_x_realtime": round(chunk_s / med, 1),
            "latency_s_buffered_plus_wall": round(buffered_s + med, 3),
            "throughput_whole_stream_x": round(len(x) / cfg.fs / total, 1),
            "n_chunks": int(len(walls)),
            "first_call_s_incl_compile": round(compile_s, 1),
        })
        print(json.dumps(results[-1]), flush=True)
    return results


def paced_multistream(make_conv, n_streams: int, chunk_s: float,
                      n_ticks: int, x: np.ndarray, cfg=DEFAULT_WORLD,
                      clock=time.perf_counter, sleep=time.sleep) -> dict:
    """Real-time-paced multi-stream tick loop (one batched device call per
    tick across all streams).  The feed wraps around ``x``, so ``n_ticks``
    does not depend on its length."""
    conv = make_conv(chunk_s)
    m = MultiStreamConverter(conv, [("S0", "S1")] * n_streams,
                             chunk_s=chunk_s)
    feed = m.streams[0].chunk
    halo = m.streams[0].halo

    def take(start: int, ln: int) -> np.ndarray:
        return x[(start + np.arange(ln)) % len(x)]

    reset_counts()
    t0 = clock()
    for i in range(n_streams):      # primes the buffers; the last ticks
        m.push(i, take(0, feed + 2 * halo))
    compile_s = clock() - t0
    common.require_launches(common.DIO_KERNELS, conv.device,
                            "bench streaming (paced)")
    fed = feed + 2 * halo
    for i in range(n_streams):      # one throwaway tick, then pace
        m.push(i, take(fed, feed))
    fed += feed

    period = chunk_s
    walls, misses, lags = [], 0, []
    t_base = clock()
    for k in range(n_ticks):
        due = t_base + k * period        # audio for tick k arrives here
        now = clock()
        if now < due:
            sleep(due - now)
        t1 = clock()
        for i in range(n_streams):
            m.push(i, take(fed, feed))
        done = clock()
        walls.append(done - t1)
        lags.append(done - due)
        if done > due + period:          # playback buffer would underrun
            misses += 1
        fed += feed
    m.flush_all()
    w = np.array(walls)
    out = {
        "n_streams": n_streams, "chunk_s": chunk_s, "paced": True,
        "n_ticks": n_ticks,
        "p50_tick_wall_s": round(float(np.percentile(w, 50)), 4),
        "p90_tick_wall_s": round(float(np.percentile(w, 90)), 4),
        "p99_tick_wall_s": round(float(np.percentile(w, 99)), 4),
        "max_tick_wall_s": round(float(w.max()), 4),
        "deadline_miss_rate": round(misses / n_ticks, 4),
        "max_completion_lag_s": round(float(np.max(lags)), 4),
        "aggregate_x_realtime_at_pace": round(
            n_streams * chunk_s / float(np.percentile(w, 50)), 1),
        "per_stream_latency_s_p50": round(
            (feed + 2 * halo) / cfg.fs + float(np.percentile(w, 50)), 3),
        "first_tick_s_incl_compile": round(compile_s, 1),
    }
    print(json.dumps(out), flush=True)
    return out


def run(chunks=(0.5, 1.0, 2.0), streams=(4, 8, 16), paced_chunks=(0.5, 1.0),
        ticks: int = 100, skip_single: bool = False, skip_paced: bool = False,
        device="cuda", signal_s: float = 30.0) -> dict:
    """The JAX script's sweep and paced configs on ``device`` (the card by
    default) over ``signal_s`` seconds of its signal; returns the final
    record."""
    dev = resolve(device)
    cfg = DEFAULT_WORLD
    make_conv = converter_factory(dev, cfg)
    x = signal(cfg, signal_s)
    results = ([] if skip_single
               else single_stream_sweep(make_conv, chunks, x, cfg))
    paced = []
    if not skip_paced:
        for chunk_s in paced_chunks:
            for n in streams:
                paced.append(paced_multistream(make_conv, n, chunk_s, ticks,
                                               x, cfg))
    return {
        "metric": "streaming conversion (single chip)",
        "encoding": "ulaw8",
        "device": common.device_name(dev),
        "sweep": results,
        "paced_multistream": paced,
    }


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("chunks_pos", nargs="*", type=float,
                   help="single-stream chunk sweep (positional)")
    p.add_argument("--streams", default="4,8,16")
    p.add_argument("--paced-chunks", default="0.5,1.0")
    p.add_argument("--ticks", type=int, default=100)
    p.add_argument("--skip-single", action="store_true")
    p.add_argument("--skip-paced", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    print(json.dumps(run(
        chunks=a.chunks_pos or [0.5, 1.0, 2.0],
        streams=[int(s) for s in a.streams.split(",")],
        paced_chunks=[float(c) for c in a.paced_chunks.split(",")],
        ticks=a.ticks, skip_single=a.skip_single, skip_paced=a.skip_paced,
        device=a.device)))


if __name__ == "__main__":
    main()
