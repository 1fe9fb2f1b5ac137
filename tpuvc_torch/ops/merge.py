"""Harvest's channel merge (K12): each band-bank channel's f0 candidate
from its four event-interval tracks, and the merge of adjacent channels
that agree into at most ``HARVEST_MAX_CANDIDATES`` candidates per frame.

A channel proposes its tracks' mean where the four agree (the largest
deviation from the mean within ``HARVEST_CONSISTENCY`` of it), all four are
positive and the mean lies inside the f0 range and inside the channel's
band (half to ``HARVEST_BAND_GATE_HIGH`` times its centre frequency).
Walking the channels up the bank, consecutive proposals within
``HARVEST_MERGE_TOLERANCE`` of the previous one form a region; each region
emits its mean, in ascending-frequency order, at most K per frame.  The
JAX package computes the same in ``tpuvc/dsp/harvest.py:_channel_candidates``
and ``_merge_channels`` (a ``jax.lax.scan`` over the channels).

CUDA kernel (``csrc/merge.cu``); it replaces no Pallas kernel.  It was
added because the merge, run as a Python loop over the channels, launched
~32 small kernels a channel, ~4,900 for one Harvest corpus request of 64
rows x 152 channels, and the host's launches set the pace while the card
idled.  Bound: the bytes of the tracks, read once.  One thread per (row,
frame) walks the channels, consecutive threads on consecutive frames so
each track load is coalesced, with the next channel's loads in flight
while the current one merges.  Bit-equal to :func:`merge_channels_plain`:
the same IEEE operations in the same order (the mean of four summed
left to right, written out here so that ATen's reduction order decides
nothing).
"""

from __future__ import annotations

import torch

from tpuvc_torch.dsp.constants import (HARVEST_BAND_GATE_HIGH,
                                       HARVEST_CONSISTENCY,
                                       HARVEST_MAX_CANDIDATES,
                                       HARVEST_MERGE_TOLERANCE)
from tpuvc_torch.ops import _build

_K = HARVEST_MAX_CANDIDATES


def channel_candidates(tracks: torch.Tensor, bfs: torch.Tensor,
                       floor: float, ceil: float):
    """[B, C, 4, N] tracks -> per-channel (candidate, deviation) [B, C, N];
    0 and +inf where a channel proposes nothing."""
    t0, t1, t2, t3 = tracks.unbind(2)
    mean = (((t0 + t1) + t2) + t3) / 4.0
    dev = (torch.amax(torch.abs(tracks - mean[:, :, None, :]), dim=2)
           / torch.clamp(mean, min=1e-12))
    bf = bfs[:, None]
    ok = (torch.all(tracks > 0.0, dim=2) & (dev <= HARVEST_CONSISTENCY)
          & (mean >= floor) & (mean <= ceil) & (mean >= bf / 2.0)
          & (mean <= bf * HARVEST_BAND_GATE_HIGH))
    return (torch.where(ok, mean, 0.0),
            torch.where(ok, dev, torch.inf))


def merge_runs(cand: torch.Tensor, dev: torch.Tensor):
    """[B, C, N] per-channel candidates -> [B, N, K] merged candidates and
    each region's best deviation (+inf in slots never filled).

    Consecutive channels whose candidates agree within the merge
    tolerance form one region; the region's candidate is its mean, its
    quality the best deviation.  A loop over the channel axis; regions
    emit in ascending-frequency order, at most K per frame.
    """
    bsz, _, n = cand.shape
    dev_ = cand.device
    slots = torch.arange(_K, device=dev_)
    run_sum = torch.zeros((bsz, n), device=dev_)
    run_cnt = torch.zeros((bsz, n), device=dev_)
    run_best = torch.full((bsz, n), torch.inf, device=dev_)
    prev = torch.zeros((bsz, n), device=dev_)
    filled = torch.zeros((bsz, n), dtype=torch.int64, device=dev_)
    out_v = torch.zeros((bsz, n, _K), device=dev_)
    out_d = torch.full((bsz, n, _K), torch.inf, device=dev_)
    zero = torch.zeros((), device=dev_)

    def emit(value, best, do_emit):
        nonlocal filled, out_v, out_d
        can = do_emit & (filled < _K)
        write = ((slots == torch.clamp(filled, max=_K - 1)[..., None])
                 & can[..., None])
        out_v = torch.where(write, value[..., None], out_v)
        out_d = torch.where(write, best[..., None], out_d)
        filled = filled + can.to(torch.int64)

    for ci in range(cand.shape[1]):
        c_i, d_i = cand[:, ci], dev[:, ci]
        valid = c_i > 0.0
        cont = (valid & (prev > 0.0)
                & (torch.abs(c_i - prev)
                   < HARVEST_MERGE_TOLERANCE * torch.clamp(prev, min=1e-12)))
        emit(run_sum / torch.clamp(run_cnt, min=1.0), run_best,
             (run_cnt > 0.0) & ~cont)
        run_sum = torch.where(cont, run_sum + c_i,
                              torch.where(valid, c_i, zero))
        run_cnt = torch.where(cont, run_cnt + 1.0,
                              torch.where(valid, 1.0, zero))
        run_best = torch.where(cont, torch.minimum(run_best, d_i),
                               torch.where(valid, d_i, torch.inf))
        prev = c_i
    emit(run_sum / torch.clamp(run_cnt, min=1.0), run_best, run_cnt > 0.0)
    return out_v, out_d


def merge_channels_plain(tracks: torch.Tensor, bfs: torch.Tensor,
                         floor: float, ceil: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`merge_channels` (same contract)."""
    return merge_runs(*channel_candidates(tracks, bfs, floor, ceil))[0]


def merge_channels(tracks: torch.Tensor, bfs: torch.Tensor, floor: float,
                   ceil: float) -> torch.Tensor:
    """tracks [B, C, 4, N] float32 contiguous (each channel's four
    event-interval tracks on the 1 ms grid), bfs [C] float32 (the channels'
    centre frequencies), the f0 range [floor, ceil] in Hz -> the merged
    candidates [B, N, K] float32, 0 in slots no region filled.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises).
    """
    if (tracks.dim() != 4 or tracks.shape[2] != 4
            or tracks.dtype != torch.float32):
        raise ValueError(f"merge_channels needs tracks [B, C, 4, N] float32, "
                         f"got {tuple(tracks.shape)} {tracks.dtype}")
    if (bfs.dim() != 1 or bfs.dtype != torch.float32
            or bfs.shape[0] != tracks.shape[1]):
        raise ValueError(f"merge_channels needs bfs [C] float32 for the "
                         f"{tracks.shape[1]} channels, got "
                         f"{tuple(bfs.shape)} {bfs.dtype}")
    if bfs.device != tracks.device:
        raise ValueError(f"merge_channels: tracks on {tracks.device}, bfs on "
                         f"{bfs.device}")
    if not tracks.is_contiguous():
        raise ValueError("merge_channels needs contiguous tracks")
    if tracks.device.type == "cpu":
        return merge_channels_plain(tracks, bfs, floor, ceil)
    if tracks.device.type != "cuda":
        raise ValueError(f"merge_channels: no kernel on {tracks.device}")
    b, c, _, n = tracks.shape
    bfs = bfs.contiguous()
    out = torch.empty((b, n, _K), device=tracks.device)
    _build.launch("tpuvc_merge_channels", tracks.device, tracks.data_ptr(),
                  bfs.data_ptr(), out.data_ptr(), b, c, n, floor, ceil,
                  HARVEST_CONSISTENCY, HARVEST_BAND_GATE_HIGH,
                  HARVEST_MERGE_TOLERANCE)
    _build.count("merge")
    return out
