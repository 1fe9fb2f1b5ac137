"""Live streams: N callers each deliver fixed chunks in real time (an
open loop), aligned so that one ``MultiStreamConverter`` tick serves
them all.

Tick k of the window is due at T0 + k * chunk_s, when every stream's
chunk k has fully arrived; the harness waits for the due time, pushes
every stream's chunk (the last push runs the tick's batched call) and
takes the converted audio back on the host.  End to end:
``chunk_lag_p95_ms``, the 95th percentile over all chunk deliveries of
the window of the time from a chunk's due time to its converted audio on
the host (a failed tick counts its chunks as infinitely late).  The
window holds ceil(seconds / chunk_s) ticks and ends when the last is
delivered; how late the generator started each tick is reported beside.
The check converts a seeded sample of ticks again with the plain
reference under the streaming semantics (windows of [halo | chunk |
halo], a seed per stream and window, the equal-power crossfade) and
compares every stream's audio of those ticks.
"""

from __future__ import annotations

import math
import sys
import time
import traceback

import numpy as np
import torch

from benchmark import generate
from benchmark.drivers.corpus import (generator_weights, make_converter,
                                      make_reference)
from benchmark.reference import convert as ref


def tail(values, q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q <= 1) of ``values``: an
    infinite value (a chunk never delivered) stays infinite."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def stream_geometry(traffic: dict, world: ref.World) -> tuple[int, int]:
    """(chunk, halo) in samples, as the streaming converter sets them:
    whole frames, the halo at least the largest analysis window."""
    hop, fs = world.hop, world.fs
    chunk = int(traffic["chunk_s"] * fs) // hop * hop
    halo = max(2048, int(traffic["halo_s"] * fs)) // hop * hop
    return chunk, halo


def reference_pieces(reference: ref.Reference, streams: list, pairs: list,
                     seeds: list, tick: int, chunk: int, halo: int
                     ) -> list[np.ndarray]:
    """Every stream's converted audio of tick ``tick`` (>= 1) as the
    streaming converter promises it: window j of a stream is audio[j chunk
    : j chunk + chunk + 2 halo], converted with the noise seed ``seed + j``;
    tick j emits window j's samples [halo, halo + chunk), the first halo
    of them crossfaded (sin in, cos out) with window j - 1's samples
    [chunk + halo, chunk + 2 halo).  The windows of one tick are
    converted together, as the converter's tick converts them."""
    span = chunk + 2 * halo
    ys = []
    for j in (tick - 1, tick):
        ys.append(reference.convert_batch(
            [a[j * chunk: j * chunk + span] for a in streams],
            [p[0] for p in pairs], [p[1] for p in pairs],
            np.asarray(seeds) + j))
    theta = np.linspace(0.0, np.pi / 2.0, halo, dtype=np.float32)
    xf_new, xf_old = np.sin(theta), np.cos(theta)
    out = []
    for prev, cur in zip(*ys):
        piece = np.asarray(cur[halo: halo + chunk], np.float32).copy()
        tail = np.asarray(prev[chunk + halo: chunk + 2 * halo], np.float32)
        piece[:halo] = tail * xf_old + piece[:halo] * xf_new
        out.append(piece)
    return out


class Cell:
    def __init__(self, run):
        self.run = run

    def setup(self) -> None:
        from tpuvc_torch.convert.streaming import MultiStreamConverter
        run, t = self.run, self.run.traffic
        self.state = generator_weights(run, run.config)
        self.assets = generate.assets(run.seed, run.config)
        conv = make_converter(run, self.state, self.assets, t["transfer"])
        self.traffic = generate.LiveTraffic(run.seed, t, run.config,
                                            run.device)
        names = self.assets["speakers"]
        self.pairs = [(names[s], names[d]) for s, d in
                      zip(self.traffic.src, self.traffic.trg)]
        self.multi = MultiStreamConverter(
            conv, self.pairs, chunk_s=t["chunk_s"], halo_s=t["halo_s"],
            seed=self.traffic.seed_base)
        self.chunk, self.halo = stream_geometry(
            t, ref.World(**run.config["world"]))
        self.fed = 0
        self.outs = [[] for _ in self.pairs]
        self._push_all(self.chunk + 2 * self.halo)     # the first window
        for _ in range(t["warmup_ticks"]):
            self._push_all(self.chunk)

    def _push_all(self, n: int) -> None:
        for i, a in enumerate(self.traffic.audio):
            self.outs[i].append(self.multi.push(i, a[self.fed: self.fed + n]))
        self.fed += n

    def window(self, seconds: float) -> None:
        run = self.run
        period = self.run.traffic["chunk_s"]
        n_ticks = math.ceil(seconds / period)
        n = len(self.pairs)
        lags, walls, late = [], [], []
        t0 = time.perf_counter()
        for k in range(n_ticks):
            due = t0 + k * period
            now = time.perf_counter()
            if now < due:
                time.sleep(due - now)
            t1 = time.perf_counter()
            ok = True
            with torch.profiler.record_function("bench.tick"):
                try:
                    self._push_all(self.chunk)
                except Exception:     # the tick's chunks are never delivered
                    traceback.print_exc(file=sys.stderr)
                    ok = False
            done = time.perf_counter()
            run.attempted += n
            if not ok:
                run.failed += n
            lags += [done - due if ok else math.inf] * n
            walls.append(done - t1)
            late.append(t1 - due)
            run.counters.update(ticks=k + 1, window_s=done - t0)
            run.spans["bench.tick"] = walls
            run.boundary()
        for i in range(n):              # the audio of the last tick
            self.outs[i].append(self.multi.push(i, np.zeros(0, np.float32)))
        run.end_to_end["chunk_lag_p95_ms"] = 1e3 * tail(lags, 0.95)
        self.late = late
        run.notes = {"generator_late_ms_p95": 1e3 * tail(late, 0.95),
                     "generator_late_ms_max": 1e3 * max(late)}

    def release(self) -> None:
        self.multi = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list[int]:
        """The seeded sample of ticks (>= 1) whose every stream's audio
        the check converts again."""
        n_ticks = (self.fed - 2 * self.halo) // self.chunk
        n = min(self.run.traffic["check_ticks"], n_ticks - 1)
        rng = np.random.default_rng(generate.derive(self.run.seed, "check"))
        return sorted(1 + rng.choice(n_ticks - 1, size=n, replace=False))

    def _piece(self, stream: int, tick: int) -> np.ndarray:
        """The program's audio of ``tick`` for ``stream``: the first tick
        emits chunk + halo samples, every later one chunk."""
        out = np.concatenate(self.outs[stream])
        at = self.chunk + self.halo + (tick - 1) * self.chunk
        return out[at: at + self.chunk]

    def readings(self, reference: ref.Reference,
                 control: ref.Reference | None = None) -> list[float]:
        """Each sampled tick's error in dB for every stream: the
        program's audio (or ``control``'s) against ``reference``'s, over
        that chunk's energy or the tick's median chunk energy, whichever
        is larger (a chunk inside a pause carries only codec steps)."""
        n = len(self.pairs)
        # the streaming converter's seeds: stream i's base plus 7919 i
        seeds = [self.traffic.seed_base + 7919 * i for i in range(n)]
        args = (self.traffic.audio, self.pairs, seeds)
        errs = []
        for tick in self.sample():
            want = reference_pieces(reference, *args, tick, self.chunk,
                                    self.halo)
            got = ([self._piece(i, tick) for i in range(n)]
                   if control is None else reference_pieces(
                       control, *args, tick, self.chunk, self.halo))
            floor = float(np.median([np.sum(np.square(w, dtype=np.float64))
                                     for w in want]))
            errs += [ref.error_db(g, w, 0, floor) for g, w in zip(got, want)]
        return errs

    def _reference(self, degrade=None) -> ref.Reference:
        return make_reference(self.run, self.state, self.assets,
                              self.run.traffic["transfer"], degrade)

    def check(self) -> dict:
        errs = self.readings(self._reference())
        lim = self.run.limits
        return {"chunk_err_db_max": (float(np.max(errs)),
                                     lim["chunk_err_db_max"]),
                "chunk_err_db_median": (float(np.median(errs)),
                                        lim["chunk_err_db_median"])}

    def control_readings(self, halves: bool = False) -> dict:
        """As the corpus cells': the program, the control and, with
        ``halves``, each half of the control."""
        reference = self._reference()
        out = {}
        sides = [("program", None), ("control", "both")]
        if halves:
            sides += [("model", "model"), ("features", "features")]
        for side, c in sides:
            errs = self.readings(reference, c and self._reference(c))
            out[side] = {"chunk_err_db_max": float(np.max(errs)),
                         "chunk_err_db_median": float(np.median(errs))}
        return out
