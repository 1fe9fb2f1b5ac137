"""DIO fundamental-frequency estimation, batched over utterances.

Port of ``tpuvc/dsp/dio.py:dio``: decimate to 4 kHz, a bank of Nuttall
low-pass channels (2 per octave between f0_floor and f0_ceil), four
event-interval estimators per channel (zero crossings both ways, peaks,
dips), the best channel per frame, then WORLD's contour fixing.

The event stage goes through the event kernel
(``tpuvc_torch/ops/events.py``), and the block-level prefix/suffix top-2
scans of all four event types through the scan kernel of the same module
(``events.top2_block_scans``, one pass; on a CPU tensor its plain version,
the exact cummax identity of ``dio._top2_max_scan``, gives the same bits).
The JAX package chooses between the two with ``TPUVC_SCAN``; the port
needs no switch, as the kernel is the faster route on the card.  The frame
reads are ``dio._tracks_from_pairs``.  The two candidate-guided extension
passes, serial by data dependence, run in one launch of the contour kernel
(``ops/contour.py:extend_scans``; its plain version, the loop over frames,
on a CPU tensor).

Two stage spans (``utils/profiling.span``) split a profile of ``dio``:
``dio_bank`` (decimation, the filter bank and the event tracks: K1 and K7)
and ``dio_contour`` (the candidate pick, the fix steps and both extension
passes).
"""

from __future__ import annotations

import math

import torch

from tpuvc_torch.dsp import filters
from tpuvc_torch.dsp.constants import (DEFAULT_WORLD, DIO_ALLOWED_RANGE,
                                       DIO_CHANNELS_IN_OCTAVE,
                                       DIO_SCORE_CUTOFF, DIO_TARGET_FS,
                                       DIO_VOICE_RANGE_MINIMUM)
from tpuvc_torch.ops.arith import rdiv
from tpuvc_torch.ops.contour import extend_scans
from tpuvc_torch.ops.events import event_block_pairs, top2_block_scans
from tpuvc_torch.utils.profiling import span


def _boundary_f0s(f0_floor: float, f0_ceil: float) -> tuple[float, ...]:
    n = 1 + int(math.log2(f0_ceil / f0_floor) * DIO_CHANNELS_IN_OCTAVE)
    return tuple(f0_floor * 2.0 ** ((i + 1) / DIO_CHANNELS_IN_OCTAVE)
                 for i in range(n))


def _edge_pad(v: torch.Tensor, n: int) -> torch.Tensor:
    """v[:, :n], extended by repeating the last column if v is short."""
    if v.shape[-1] >= n:
        return v[:, :n]
    return torch.cat([v, v[:, -1:].expand(-1, n - v.shape[-1])], dim=-1)


def _tracks_from_pairs(p1, p2, s1, s2, fs_d: float, n_frames: int,
                       stride: int, ncells: int) -> torch.Tensor:
    """One event type's block scans [R, nb] -> its f0 track [R, N] (port
    of tpuvc/dsp/dio.py:_tracks_from_pairs): p1/p2 the prefix top-2 of the
    block maxima, s1/s2 the suffix bottom-2 of the block minima."""
    neg = torch.full_like(p1[:, :1], -torch.inf)
    n_read = ncells // stride + 1
    a = _edge_pad(torch.cat([neg, p1], dim=-1)[:, :n_read], n_frames)
    a0 = _edge_pad(torch.cat([neg, p2], dim=-1)[:, :n_read], n_frames)
    b = _edge_pad(s1, n_frames)
    b2 = _edge_pad(s2, n_frames)
    left_ok = torch.isfinite(a0) & (a0 < a - 1e-3)
    right_ok = torch.isfinite(b2) & (b2 > b + 1e-3)

    t = (torch.arange(n_frames, dtype=torch.float32, device=p1.device)
         * float(stride))[None, :]
    v_mid = rdiv(fs_d, torch.clamp(b - a, min=1e-6))
    v_left = rdiv(fs_d, torch.clamp(a - a0, min=1e-6))
    v_right = rdiv(fs_d, torch.clamp(b2 - b, min=1e-6))
    m_left = 0.5 * (a0 + a)
    m_mid = 0.5 * (a + b)
    m_right = 0.5 * (b + b2)
    wl = torch.clamp((t - m_left) / torch.clamp(m_mid - m_left, min=1e-6),
                     0.0, 1.0)
    f_left = torch.where(left_ok, v_left + wl * (v_mid - v_left), v_mid)
    wr = torch.clamp((t - m_mid) / torch.clamp(m_right - m_mid, min=1e-6),
                     0.0, 1.0)
    f_right = torch.where(right_ok, v_mid + wr * (v_right - v_mid), v_mid)
    interp = torch.where(t < m_mid, f_left, f_right)

    valid = torch.isfinite(a) & torch.isfinite(b) & (b > a)
    # edge hold: frames before the first event read the first interval's
    # f0, frames after the last event the last one's; fs_d*d/max(d^2,1e-6)
    # is 0 for a degenerate (duplicate-time) pair (see the JAX source)
    e0, e1 = s1[:, :1], s2[:, :1]
    en, en1 = p1[:, -1:], p2[:, -1:]
    df = e1 - e0
    dl = en - en1
    zero = torch.zeros((), device=p1.device)
    first = torch.where(torch.isfinite(e0) & torch.isfinite(e1),
                        fs_d * df / torch.clamp(df * df, min=1e-6), zero)
    last = torch.where(torch.isfinite(en) & torch.isfinite(en1),
                       fs_d * dl / torch.clamp(dl * dl, min=1e-6), zero)
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    edge = torch.where(~fa & fb, first, torch.where(fa & ~fb, last, zero))
    return torch.where(valid, interp, edge)


def _bank_tracks(filtered: torch.Tensor, fs_d: float, n_frames: int,
                 stride: int) -> torch.Tensor:
    """Event-interval f0 tracks for a channel bank: [R, Td] -> [R, 4, N]."""
    t = filtered.shape[-1]
    pairs = event_block_pairs(filtered.contiguous(), stride)  # [R, 16, nb]
    # the derivative types' trailing block (past T-2 cells) is all fill,
    # inert in both scan directions: scan whole rows, then slice per type
    scans = top2_block_scans(pairs)
    del pairs           # Harvest's is 4.6 GiB at 128 x 4 s: free it early
    nb_zc = -(-(t - 1) // stride)
    nb_pd = -(-(t - 2) // stride)
    rows = []
    for ti, (nc, nb) in enumerate(((t - 1, nb_zc), (t - 1, nb_zc),
                                   (t - 2, nb_pd), (t - 2, nb_pd))):
        rows.append(_tracks_from_pairs(
            scans[:, 4 * ti, :nb], scans[:, 4 * ti + 1, :nb],
            scans[:, 4 * ti + 2, :nb], scans[:, 4 * ti + 3, :nb],
            fs_d, n_frames, stride, nc))
    return torch.stack(rows, dim=1)


def _fix_step_remove_jumps(f0: torch.Tensor, allowed: float
                           ) -> torch.Tensor:
    prev = torch.cat([f0[:, :1], f0[:, :-1]], dim=-1)
    rel = torch.abs(f0 - prev) / torch.clamp(f0, min=1e-6)
    return torch.where((prev > 0) & (rel > allowed), 0.0, f0)


def _fix_step_remove_short_runs(f0: torch.Tensor, min_len: int
                                ) -> torch.Tensor:
    """Zero voiced runs shorter than min_len frames (morphological opening
    by exact integer-cumsum window sums)."""
    m = min_len
    if m > f0.shape[-1]:
        return torch.zeros_like(f0)
    v = (f0 > 0).to(torch.int64)
    z = torch.zeros_like(v[:, :1])
    cs = torch.cat([z, torch.cumsum(v, dim=-1)], dim=-1)
    erode = (cs[:, m:] - cs[:, :-m] == m).to(torch.int64)   # [B, n-m+1]
    ep = torch.nn.functional.pad(erode, (m - 1, m - 1))
    ce = torch.cat([z, torch.cumsum(ep, dim=-1)], dim=-1)
    keep = (ce[:, m:] - ce[:, :-m]) > 0                       # [B, n]
    return torch.where(keep, f0, 0.0)


def dio(x: torch.Tensor, fs: int = DEFAULT_WORLD.fs,
        hop: int = DEFAULT_WORLD.hop,
        f0_floor: float = DEFAULT_WORLD.f0_floor,
        f0_ceil: float = DEFAULT_WORLD.f0_ceil) -> torch.Tensor:
    """f0 for every frame of x [B, T]; returns [B, T//hop + 1] in Hz,
    0 = unvoiced."""
    x = x.to(torch.float32)
    bsz = x.shape[0]
    n_frames = x.shape[-1] // hop + 1
    ratio = max(1, min(12, int(fs / DIO_TARGET_FS)))
    while hop % ratio:
        ratio -= 1
    fs_d = fs / ratio
    bounds = _boundary_f0s(f0_floor, f0_ceil)
    with span("dio_bank"):
        y = filters.decimate(x, ratio)
        y = y - torch.mean(y, dim=-1, keepdim=True)
        filtered = filters.lowpass_bank_fft(y, fs_d, bounds)  # [B, C, Td]
        c = filtered.shape[1]
        stride = hop // ratio
        tracks = _bank_tracks(filtered.reshape(bsz * c, -1), fs_d, n_frames,
                              stride).reshape(bsz, c, 4, n_frames)
    with span("dio_contour"):
        return _contour(tracks, bounds, f0_floor, f0_ceil)


def _contour(tracks: torch.Tensor, bounds: tuple[float, ...],
             f0_floor: float, f0_ceil: float) -> torch.Tensor:
    """The channels' tracks [B, C, 4, N] -> f0 [B, N]: the best channel
    per frame, then WORLD's contour fixing."""
    cand = torch.mean(tracks, dim=2)                          # [B, C, N]
    dev = torch.sqrt(torch.sum((tracks - cand[:, :, None, :]) ** 2, dim=2)
                     / 3.0)
    score = dev / torch.clamp(cand, min=1e-6)
    bf = torch.tensor(bounds, dtype=torch.float32,
                      device=tracks.device)[:, None]
    in_range = ((cand >= f0_floor) & (cand <= f0_ceil)
                & (cand >= bf / 2.0) & (cand <= bf))
    score = torch.where(in_range, score, torch.inf)
    cand = torch.where(in_range, cand, 0.0)

    best = torch.argmin(score, dim=1, keepdim=True)           # [B, 1, N]
    best_cand = torch.gather(cand, 1, best)[:, 0]
    best_score = torch.gather(score, 1, best)[:, 0]
    f0 = torch.where(best_score < DIO_SCORE_CUTOFF, best_cand, 0.0)

    cands_t = cand.transpose(1, 2)                            # [B, N, C]
    f0 = _fix_step_remove_jumps(f0, DIO_ALLOWED_RANGE)
    f0 = _fix_step_remove_short_runs(f0, DIO_VOICE_RANGE_MINIMUM)
    f0 = extend_scans(f0, cands_t, DIO_ALLOWED_RANGE)
    return _fix_step_remove_short_runs(f0, DIO_VOICE_RANGE_MINIMUM)
