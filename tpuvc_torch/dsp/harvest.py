"""Harvest f0 estimation, batched over utterances.

Port of ``tpuvc/dsp/harvest.py:harvest`` (WORLD's Harvest, Morise,
Interspeech 2017):

  1. decimate to 8 kHz; one band-pass channel per 1/40 octave between
     0.9 f0_floor and 1.1 f0_ceil (152 channels at 71-800 Hz), all in one
     batched FFT (``filters.bandpass_bank_fft``); ``channel_decim`` > 1
     keeps every ``channel_decim``-th channel (the fast mode: 76 channels,
     1/20 octave, at 2);
  2. per channel, DIO's four event-interval tracks on a 1 ms frame grid
     (``dio._bank_tracks``: the event kernel at stride fs_d/1000 = 8); a
     channel proposes its track mean where the four agree;
  3. adjacent channels proposing the same f0 merge into at most 10
     candidates per frame (``ops/merge.py:merge_channels``, the channel
     candidates and their merge in one launch of K12 on the card);
  4. each candidate is refined by the instantaneous-frequency method on
     the original-rate signal and scored by harmonic concentration, both
     phases in one kernel (``ops/harmonics.py:refine_score``, the JAX
     package's ``TPUVC_REFINE=merged`` route, which computes the same
     numbers as its two-pass route);
  5. contour: the best-scoring candidate per frame, moving-median guided
     reselection, jump removal and short-run removal, candidate extension
     both ways (``ops/contour.py:extend_scans``, one launch of the contour
     kernel on the card), and WORLD's zero-phase biquad
     smoothing; the 1 ms track is strided down to the output frames.

The contour recurrences over the 1 ms grid (jump removal, forward fill,
biquad) run in the JAX package's blocked forms: a loop over the 128
frames of a block, vectorised across all blocks, then a short loop over
the blocks for the carry.  They equal the flat recurrences
(``tests/test_f0.py::test_blocked_contour_recurrences_match_flat_scans``).

The five stages carry stage spans (``utils/profiling.span``) named as the
JAX package's ``jax.named_scope``s: ``hv_band_bank`` (1),
``hv_event_tracks`` (2), ``hv_merge`` (the channel candidates and 3),
``hv_refine`` (4) and ``hv_contour`` (5), so a profile attributes its
time per stage; outside a profile each costs one query of whether a
profiler records.  Each of the six blocked-recurrence calls of a Harvest
call (two jump removals in ``hv_contour``, two fills and two biquads in
its smoothing) carries a span ``hv_recur`` of its own, nested in
``hv_contour`` and with no JAX counterpart: it splits the contour's
host-launched loops from the contour kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tpuvc_torch.dsp import filters
from tpuvc_torch.dsp.constants import (DEFAULT_WORLD, HARVEST_CEIL_ADJUST,
                                       HARVEST_CHANNELS_IN_OCTAVE,
                                       HARVEST_EXTENSION_ALLOWED,
                                       HARVEST_FLOOR_ADJUST,
                                       HARVEST_MAX_CANDIDATES,
                                       HARVEST_REFINE_LIMIT,
                                       HARVEST_RESELECT_HALF,
                                       HARVEST_RESELECT_REL,
                                       HARVEST_SMOOTH_A1, HARVEST_SMOOTH_A2,
                                       HARVEST_SMOOTH_B,
                                       HARVEST_STEP1_ALLOWED,
                                       HARVEST_TARGET_FS,
                                       HARVEST_VOICE_RANGE_MIN,
                                       harvest_refine_window)
from tpuvc_torch.dsp.dio import _bank_tracks, _fix_step_remove_short_runs
from tpuvc_torch.ops.contour import extend_scans
from tpuvc_torch.ops.framing import frame_signal
from tpuvc_torch.ops.harmonics import refine_score
from tpuvc_torch.ops.merge import merge_channels
from tpuvc_torch.utils.profiling import span

_K = HARVEST_MAX_CANDIDATES
_CONTOUR_BLOCK = 128      # frames per block of the blocked recurrences


def _boundary_f0s(f0_floor: float, f0_ceil: float) -> tuple[float, ...]:
    lo = f0_floor * HARVEST_FLOOR_ADJUST
    hi = f0_ceil * HARVEST_CEIL_ADJUST
    n = 1 + int(math.log2(hi / lo) * HARVEST_CHANNELS_IN_OCTAVE)
    return tuple(lo * 2.0 ** ((i + 1) / HARVEST_CHANNELS_IN_OCTAVE)
                 for i in range(n))


def _guided_reselect(f0: torch.Tensor, refined: torch.Tensor,
                     scores: torch.Tensor) -> torch.Tensor:
    """Moving-median contour guide: a frame far from the median of its
    +-15 neighbours takes the candidate nearest that median, if one is
    within 15%.  f0 [B, N], refined/scores [B, N, K]."""
    half = HARVEST_RESELECT_HALF
    win = torch.nn.functional.pad(f0, (half, half)).unfold(
        -1, 2 * half + 1, 1)                                 # [B, N, 2h+1]
    valid = win > 0.0
    cnt = torch.sum(valid, dim=-1)
    s = torch.sort(torch.where(valid, win, torch.inf), dim=-1).values
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.div(cnt, 2, rounding_mode="floor")
    med = 0.5 * (torch.gather(s, -1, lo[..., None])[..., 0]
                 + torch.gather(s, -1, hi[..., None])[..., 0])
    med = torch.where(cnt > 0, med, 0.0)
    medc = torch.clamp(med, min=1e-12)
    need = ((f0 > 0.0) & (cnt > 0)
            & (torch.abs(f0 - med) > HARVEST_RESELECT_REL * medc))
    errs = torch.where((scores > 0.0) & (refined > 0.0),
                       torch.abs(refined - med[..., None]) / medc[..., None],
                       torch.inf)
    j = torch.argmin(errs, dim=-1, keepdim=True)
    best_err = torch.gather(errs, -1, j)[..., 0]
    best_val = torch.gather(refined, -1, j)[..., 0]
    fixed = torch.where(best_err <= HARVEST_RESELECT_REL, best_val, 0.0)
    return torch.where(need, fixed, f0)


def _blocks(v: torch.Tensor, fill=0.0) -> torch.Tensor:
    """[B, N] -> [B, nb, L] blocks of the contour block length."""
    n = v.shape[-1]
    nb = -(-n // _CONTOUR_BLOCK)
    vp = torch.nn.functional.pad(v, (0, nb * _CONTOUR_BLOCK - n), value=fill)
    return vp.reshape(v.shape[0], nb, _CONTOUR_BLOCK)


def _unblocks(vb: torch.Tensor, n: int) -> torch.Tensor:
    return vb.reshape(vb.shape[0], -1)[:, :n]


def _fix_step1_scan(f0: torch.Tensor, allowed: float) -> torch.Tensor:
    """Sequential jump removal (the updated previous value is the
    reference), blocked: every output is 0 or its own input, so the value
    entering a block is 0 or the previous block's last input.  The
    in-block recurrence runs once for each of the two carry-ins, for all
    blocks at once, and a loop over the blocks picks the realised one."""
    n = f0.shape[-1]
    fb = _blocks(f0)                                         # [B, nb, L]
    prev_last = torch.cat([torch.zeros_like(fb[:, :1, -1]), fb[:, :-1, -1]],
                          dim=1)                             # [B, nb]
    carry = torch.stack([torch.zeros_like(prev_last), prev_last])
    outs = []
    for i in range(_CONTOUR_BLOCK):
        cur = fb[None, :, :, i]
        bad = ((cur > 0.0) & (carry > 0.0)
               & (torch.abs(cur - carry)
                  > allowed * torch.clamp(cur, min=1e-12)))
        carry = torch.where(bad, 0.0, cur)
        outs.append(carry)
    outs = torch.stack(outs, dim=-1)                         # [2, B, nb, L]
    nonzero_out = outs[..., -1] > 0.0                        # [2, B, nb]
    cls = torch.zeros_like(nonzero_out[0, :, 0])
    cls_in = []
    for j in range(fb.shape[1]):
        cls_in.append(cls)
        cls = torch.where(cls, nonzero_out[1, :, j], nonzero_out[0, :, j])
    cls_in = torch.stack(cls_in, dim=1)                      # [B, nb]
    return _unblocks(torch.where(cls_in[..., None], outs[1], outs[0]), n)


def _ffill(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Forward-fill v where ~mask with the last mask-true value (positions
    before the first true value get v[0]), blocked: the in-block fill for
    all blocks at once, then a loop over the blocks for the carry."""
    n = v.shape[-1]
    vb, mb = _blocks(v), _blocks(mask, False)
    c = vb[..., 0]
    loc = []
    for i in range(_CONTOUR_BLOCK):
        c = torch.where(mb[..., i], vb[..., i], c)
        loc.append(c)
    loc = torch.stack(loc, dim=-1)                           # [B, nb, L]
    seen = torch.cumsum(mb.to(torch.int32), dim=-1) > 0
    has, last = seen[..., -1], loc[..., -1]
    c = v[:, 0]
    carry_in = []
    for j in range(vb.shape[1]):
        carry_in.append(c)
        c = torch.where(has[:, j], last[:, j], c)
    carry_in = torch.stack(carry_in, dim=1)                  # [B, nb]
    return _unblocks(torch.where(seen, loc, carry_in[..., None]), n)


@functools.lru_cache(maxsize=4)
def _biquad_hom(length: int) -> np.ndarray:
    """Zero-input responses of the smoothing biquad to the four unit
    initial states (x1, x2, y1, y2), rows 0..length-1: float64 on the
    host, the constants of the blocked formulation."""
    b0, b1, b2 = HARVEST_SMOOTH_B
    a1, a2 = HARVEST_SMOOTH_A1, HARVEST_SMOOTH_A2
    c = np.zeros((length, 4), np.float64)
    for k in range(4):
        x1, x2, y1, y2 = (float(k == 0), float(k == 1),
                          float(k == 2), float(k == 3))
        for i in range(length):
            yi = b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
            c[i, k] = yi
            x2, x1 = x1, 0.0
            y2, y1 = y1, yi
    return c.astype(np.float32)


def _biquad(v: torch.Tensor) -> torch.Tensor:
    """The smoothing biquad over [B, N], settled at the first value,
    blocked: each block's output is its zero-state output plus c @ s_in,
    where c are the unit-state responses and s_in the incoming (x1, x2,
    y1, y2) state; states chain as s_next = g + D s.  Equal to the flat
    recurrence up to float32 reassociation (~1e-7 relative)."""
    b0, b1, b2 = HARVEST_SMOOTH_B
    a1, a2 = HARVEST_SMOOTH_A1, HARVEST_SMOOTH_A2
    n = v.shape[-1]
    xb = _blocks(v)                                          # [B, nb, L]
    x1 = x2 = y1 = y2 = torch.zeros_like(xb[..., 0])
    y0 = []
    for i in range(_CONTOUR_BLOCK):
        xi = xb[..., i]
        yi = b0 * xi + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        x1, x2, y1, y2 = xi, x1, yi, y1
        y0.append(yi)
    y0 = torch.stack(y0, dim=-1)                             # [B, nb, L]
    g = torch.stack([x1, x2, y1, y2], dim=-1)                # [B, nb, 4]
    c = torch.from_numpy(_biquad_hom(_CONTOUR_BLOCK)).to(v.device)
    zero4 = torch.zeros(4, device=v.device)
    d = torch.stack([zero4, zero4, c[-1], c[-2]])            # [4, 4]
    s = v[:, :1].expand(-1, 4)                               # settled
    s_in = []
    for j in range(xb.shape[1]):
        s_in.append(s)
        s = g[:, j] + s @ d.T
    s_in = torch.stack(s_in, dim=1)                          # [B, nb, 4]
    return _unblocks(y0 + s_in @ c.T, n)


def _smooth(f0: torch.Tensor) -> torch.Tensor:
    """Zero-phase biquad on the voiced contour (WORLD SmoothF0Contour).

    Gap frames are filled so each pass enters every voiced segment
    settled at that segment's edge value: the forward pass sees gaps
    filled with the upcoming segment's head (backward fill), the backward
    pass with the previous output's tail (forward fill)."""
    v = f0 > 0.0
    with span("hv_recur"):
        bfill = _ffill(f0.flip(-1), v.flip(-1)).flip(-1)
    with span("hv_recur"):
        yf = _biquad(torch.where(v, f0, bfill))
    with span("hv_recur"):
        xb = torch.where(v, yf, _ffill(yf, v))
    with span("hv_recur"):
        yb = _biquad(xb.flip(-1)).flip(-1)
    return torch.where(v, yb, 0.0)


def harvest(x: torch.Tensor, fs: int = DEFAULT_WORLD.fs,
            hop: int = DEFAULT_WORLD.hop,
            f0_floor: float = DEFAULT_WORLD.f0_floor,
            f0_ceil: float = DEFAULT_WORLD.f0_ceil,
            channel_decim: int = 1) -> torch.Tensor:
    """f0 for every frame of x [B, T]; returns [B, T//hop + 1] in Hz,
    0 = unvoiced.  ``channel_decim`` > 1 runs the candidate bank at
    1/(40/decim) octave (the band bank and the event tracks shrink by that
    factor; the refinement's +-20% capture range pulls the surviving
    candidates to the same frequencies); 1 is WORLD's 1/40-octave bank."""
    if fs % 1000:
        raise ValueError(f"harvest needs fs divisible by 1000, got {fs}")
    if (hop * 1000) % fs:
        raise ValueError(f"hop {hop} is not a whole number of ms at {fs}")
    x = x.to(torch.float32)
    bsz, t = x.shape
    n_out = t // hop + 1
    floor = f0_floor * HARVEST_FLOOR_ADJUST
    ceil = f0_ceil * HARVEST_CEIL_ADJUST

    # the highest ratio that keeps >= 8 kHz and whole samples per 1 ms
    ratio = 1
    for r in range(1, 13):
        if (fs % r == 0 and fs / r >= HARVEST_TARGET_FS
                and (fs // r) % 1000 == 0):
            ratio = r
    fs_d = fs // ratio
    y = filters.decimate(x, ratio)
    y = y - torch.mean(y, dim=-1, keepdim=True)

    bfs = _boundary_f0s(f0_floor, f0_ceil)[::channel_decim]
    with span("hv_band_bank"):
        filtered = filters.bandpass_bank_fft(y, fs_d, bfs)  # [B, C, Td]
    n_ch = filtered.shape[1]
    n_1ms = (t * 1000) // fs + 1
    with span("hv_event_tracks"):
        tracks = _bank_tracks(filtered.reshape(bsz * n_ch, -1), fs_d, n_1ms,
                              fs_d // 1000).reshape(bsz, n_ch, 4, n_1ms)
    del filtered
    with span("hv_merge"):
        merged = merge_channels(
            tracks, torch.tensor(bfs, dtype=torch.float32, device=x.device),
            floor, ceil)                                     # [B, N, K]
        del tracks

    win = harvest_refine_window(fs, f0_floor)
    with span("hv_refine"):
        seg = frame_signal(x, fs // 1000, win, n_1ms).reshape(bsz * n_1ms,
                                                              win)
        f0_1 = torch.where(merged > 0.0, torch.clamp(merged, min=floor), 0.0)
        refined, scores = refine_score(seg, f0_1.reshape(bsz * n_1ms, _K),
                                       fs, floor, HARVEST_REFINE_LIMIT)
        del seg
        refined = refined.reshape(bsz, n_1ms, _K)
        scores = scores.reshape(bsz, n_1ms, _K)

    with span("hv_contour"):
        best = torch.argmax(scores, dim=-1, keepdim=True)
        f0 = torch.gather(refined, -1, best)[..., 0]
        f0 = torch.where(torch.gather(scores, -1, best)[..., 0] > 0.0, f0,
                         0.0)
        f0 = _guided_reselect(f0, refined, scores)
        with span("hv_recur"):
            f0 = _fix_step1_scan(f0, HARVEST_STEP1_ALLOWED)
        f0 = _fix_step_remove_short_runs(f0, HARVEST_VOICE_RANGE_MIN)
        f0 = extend_scans(f0, refined, HARVEST_EXTENSION_ALLOWED)
        with span("hv_recur"):
            f0 = _fix_step1_scan(f0, HARVEST_STEP1_ALLOWED)
        f0 = _fix_step_remove_short_runs(f0, HARVEST_VOICE_RANGE_MIN)
        f0 = _smooth(f0)
    step = (hop * 1000) // fs                                # ms per frame
    return f0[:, ::step][:, :n_out].contiguous()
