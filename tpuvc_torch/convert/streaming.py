"""Streaming conversion: fixed-size chunks through the batched converter.

Port of ``tpuvc/convert/streaming.py`` over
``tpuvc_torch.convert.pipeline.Converter`` (numpy on the host, the
conversion on the converter's device, the card by default).  Audio is
processed in fixed chunks (one shape, so one padding bucket) with a halo
of context on both sides, and consecutive converted chunks are
joined with an equal-power crossfade over the halo overlap.  The halo
covers the largest analysis window (2048 samples) plus the synthesis
response tail, so each chunk's interior is converted with full context;
the crossfade absorbs the inter-chunk excitation phase difference (pulse
phase is re-integrated per chunk).

Latency = chunk + 2 * halo; throughput = the batched converter's.
"""

from __future__ import annotations

import numpy as np

from tpuvc_torch.convert.pipeline import Converter
from tpuvc_torch.dsp.constants import DEFAULT_WORLD, WorldConfig
from tpuvc_torch.utils.profiling import span


def _refuse_vocoder(converter: Converter) -> None:
    """Streaming joins windows of [halo | chunk | halo]; a vocoder's
    receptive field (Parallel WaveGAN's stack: 6,139 samples, 0.38 s) is
    longer than the halo, so a window's interior would not see its full
    context: streaming takes WORLD's synthesis only."""
    if getattr(converter, "vocoder", None) is not None:
        raise ValueError("streaming conversion does not take a vocoder: "
                         "its halo is shorter than the vocoder's receptive "
                         "field; convert whole utterances "
                         "(Converter.convert_batch) instead")


class StreamingConverter:
    """Push-based chunked converter over a Converter (one (src, trg) pair).

    Usage::

        s = StreamingConverter(converter, "SF1", "TM3", chunk_s=1.0)
        for block in wav_blocks:          # arbitrary block sizes
            out.append(s.push(block))
        out.append(s.flush())
    """

    def __init__(self, converter: Converter, src: str, trg: str,
                 chunk_s: float = 1.0, halo_s: float = 0.192,
                 cfg: WorldConfig = DEFAULT_WORLD, seed: int = 0):
        _refuse_vocoder(converter)
        self.conv = converter
        self.src = src
        self.trg = trg
        self.cfg = cfg
        self.seed = seed
        hop = cfg.hop
        self.chunk = int(chunk_s * cfg.fs) // hop * hop
        self.halo = max(2048, int(halo_s * cfg.fs)) // hop * hop
        self._buf = np.zeros(0, np.float32)   # pending input samples
        self._tail = np.zeros(0, np.float32)  # converted halo to crossfade
        self._pos = 0                          # chunks processed
        # equal-power crossfade (sin/cos): the joined signals are only
        # weakly correlated (per-chunk re-integrated excitation phase), so
        # equal-amplitude linear ramps would dip up to ~3 dB mid-fade
        theta = np.linspace(0.0, np.pi / 2.0, self.halo, dtype=np.float32)
        self._xf_new = np.sin(theta)
        self._xf_old = np.cos(theta)

    def _convert_window(self, window: np.ndarray) -> np.ndarray:
        y = self.conv.convert(window, self.src, self.trg,
                              seed=self.seed + self._pos)
        self._pos += 1
        return np.asarray(y, np.float32)

    def _emit(self, y_win: np.ndarray, lead: int, keep: int) -> np.ndarray:
        """Take [lead, lead+keep+halo) from the converted window; crossfade
        the first halo samples against the stored tail; store a new tail."""
        seg = y_win[lead: lead + keep + self.halo]
        out = seg[: keep].copy()
        if self._tail.size:
            n = min(self._tail.size, out.size, self.halo)
            out[:n] = (self._tail[:n] * self._xf_old[:n]
                       + out[:n] * self._xf_new[:n])
        self._tail = seg[keep: keep + self.halo].copy()
        return out

    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed raw samples; returns converted audio as it becomes ready."""
        self._buf = np.concatenate(
            [self._buf, np.asarray(samples, np.float32)])
        outs = []
        # process whenever a full [halo|chunk|halo] window is available
        while self._buf.size >= self.chunk + 2 * self.halo:
            window = self._buf[: self.chunk + 2 * self.halo]
            y = self._convert_window(window)
            first = self._pos == 1
            lead = 0 if first else self.halo
            keep = self.chunk + (self.halo if first else 0)
            outs.append(self._emit(y, lead, keep))
            self._buf = self._buf[self.chunk:]
        return (np.concatenate(outs) if outs
                else np.zeros(0, np.float32))

    def flush(self) -> np.ndarray:
        """Convert whatever remains and return the final samples."""
        if self._buf.size == 0:
            tail, self._tail = self._tail, np.zeros(0, np.float32)
            return tail
        window = self._buf
        y = self._convert_window(window)[: window.size]
        first = self._pos == 1
        lead = 0 if first else self.halo
        out = y[lead:].copy()
        if self._tail.size:
            n = min(self._tail.size, out.size, self.halo)
            out[:n] = (self._tail[:n] * self._xf_old[:n]
                       + out[:n] * self._xf_new[:n])
        self._buf = np.zeros(0, np.float32)
        self._tail = np.zeros(0, np.float32)
        return out


class MultiStreamConverter:
    """N concurrent streams batched into ONE device call per tick.

    The serving-side scale-out of the streaming surface (BASELINE
    config 5): each stream keeps its own (src, trg) pair, crossfade
    state, and deterministic seed sequence; conversion happens at TICKS,
    where every stream with a ready [halo|chunk|halo] window converts
    in one batched call (Converter.convert_batch with per-row seeds) —
    per-call cost amortizes over live streams exactly as the batch bench
    amortizes over utterances.  The batch pads to the full stream count
    with repeated rows so every tick has one shape regardless of how
    many streams are ready.

    ``push`` only BUFFERS (it returns audio already converted by earlier
    ticks); a tick fires automatically once EVERY stream has a full
    window — the synchronized serving loop's steady state — or whenever
    the caller invokes :meth:`tick` (e.g. on a latency deadline with
    slow streams).  An early draft ticked eagerly per push, which made
    each batch carry exactly one real row — n streams cost n solo calls
    with zero amortization (caught in review; the auto-tick condition is
    what makes the batching real).

    Per-stream output matches a solo StreamingConverter to batching
    rounding (tests/test_streaming.py).
    """

    def __init__(self, converter: Converter, pairs, chunk_s: float = 1.0,
                 halo_s: float = 0.192, seed: int = 0, mesh=None):
        """``mesh``: a local ``tpuvc_torch.parallel.mesh`` data mesh; each
        tick's batch is split over its devices (``Converter.convert_batch``
        with ``mesh``), so N devices carry N times the streams."""
        _refuse_vocoder(converter)
        self.conv = converter
        self.pairs = list(pairs)
        self.mesh = mesh
        self.streams = [
            StreamingConverter(converter, src, trg, chunk_s=chunk_s,
                               halo_s=halo_s, seed=seed + 7919 * i)
            for i, (src, trg) in enumerate(pairs)]
        self._pending = [np.zeros(0, np.float32) for _ in self.pairs]

    def _tick(self, ready: list[int]) -> None:
        n = len(self.streams)
        with span("vc.tick"):
            with span("vc.tick_rows"):
                idx = ready + [ready[-1]] * (n - len(ready))
                rows, seeds = [], []
                for i in idx:
                    st = self.streams[i]
                    rows.append(st._buf[: st.chunk + 2 * st.halo])
                    seeds.append(st.seed + st._pos)
            ys = self.conv.convert_batch(
                rows, [self.pairs[i][0] for i in idx],
                [self.pairs[i][1] for i in idx],
                seed=np.asarray(seeds, np.int32), mesh=self.mesh)
            with span("vc.tick_emit"):
                for j, i in enumerate(ready):
                    st = self.streams[i]
                    st._pos += 1
                    y = np.asarray(ys[j], np.float32)
                    first = st._pos == 1
                    lead = 0 if first else st.halo
                    keep = st.chunk + (st.halo if first else 0)
                    piece = st._emit(y, lead, keep)
                    st._buf = st._buf[st.chunk:]
                    self._pending[i] = np.concatenate(
                        [self._pending[i], piece])

    def _ready(self) -> list[int]:
        return [i for i, s in enumerate(self.streams)
                if s._buf.size >= s.chunk + 2 * s.halo]

    def tick(self) -> list[int]:
        """Convert ALL currently ready streams in one batched device
        call; returns the stream ids converted (empty if none ready).
        Call on a latency deadline when some streams are slow;
        otherwise push() auto-ticks once every stream is ready."""
        ready = self._ready()
        if ready:
            self._tick(ready)
        return ready

    def push(self, stream_id: int, samples: np.ndarray) -> np.ndarray:
        """Buffer samples for one stream; returns that stream's audio
        converted by prior ticks.  Auto-ticks while EVERY stream has a
        full window (the synchronized steady state)."""
        with span("vc.push"):
            st = self.streams[stream_id]
            st._buf = np.concatenate([st._buf,
                                      np.asarray(samples, np.float32)])
            while len(self._ready()) == len(self.streams):
                self._tick(list(range(len(self.streams))))
            out = self._pending[stream_id]
            self._pending[stream_id] = np.zeros(0, np.float32)
            return out

    def flush_all(self) -> list[np.ndarray]:
        """Flush every stream: drain remaining full windows through
        batched ticks, then convert the ragged tail windows through the
        per-stream single-call path."""
        while self.tick():
            pass
        outs = []
        for i, st in enumerate(self.streams):
            tail = st.flush()
            outs.append(np.concatenate([self._pending[i], tail]))
            self._pending[i] = np.zeros(0, np.float32)
        return outs
