"""CheapTrick's pitch-adaptive windowing.

Replaces ``tpuvc/ops/pallas_window.py:windowed_frames_pallas`` (the
Pallas ``_kernel``): a Hanning window over 3/f0 seconds with a support
mask, the window-weighted mean removed from the windowed segment, and the
window power sum(w^2) floored at 1e-12.

Rounding: the Pallas kernel rounds the half length as
``floor(1.5 fs/f0 + 0.5)`` but the XLA path that runs off the TPU
(``tpuvc/dsp/cheaptrick.py:_windowed_frames``) uses ``jnp.rint``, which
rounds half to even.  Both versions here follow the XLA path: ``rintf`` in
the kernel, ``torch.round`` in the plain version.

CUDA kernel (``csrc/window.cu``).  Bound: device-memory bytes.  The first
design gave each frame a 256-thread block that read the whole row and
chained three block reductions, each with two barriers, so the barriers
set its time (39-42% of the full-row bound).  Now one warp per frame,
eight frames per block, no barrier: the warp loads and windows only the
float4s that meet the frame's support (:func:`support`: +-1.5 periods,
10-50% of a 1024-sample row on the path), holding up to 4 per lane in
registers (a wider support, f0 below ~94.5 Hz at 16 kHz, takes a second
pass instead), writes 0 elsewhere, and one interleaved shuffle reduction
gives every lane the three sums.  Premise: outside the support the plain
version gives x * 0 - 0 * mean = +-0 and adds +-0 to its sums, so
skipping those columns is exact for finite frames (a NaN or inf there no
longer reaches this output: ``dsp/cheaptrick.py`` makes such frames' rows
NaN, as the reference's are, from the waveform); only the order of the
sums differs (rtol 1e-5 / atol 1e-6).  The kernel takes rows of a multiple of 4 floats on 16-byte
aligned storage.
"""

from __future__ import annotations

import math

import torch

from tpuvc_torch.ops import _build
from tpuvc_torch.ops.arith import rdiv


def support(f0: torch.Tensor, fs: int, w: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """[N] f0 -> the first and last column of each frame's window support,
    [w/2 - h, w/2 + h] clipped to [0, w) with h = rint(1.5 fs / f0) as the
    kernel computes it (empty where first > last)."""
    h = torch.round(rdiv(1.5 * fs, f0)).clamp(-1, w).to(torch.int64)
    return (w // 2 - h).clamp(min=0), (w // 2 + h).clamp(max=w - 1)


def windowed_frames_plain(seg_raw: torch.Tensor, f0: torch.Tensor,
                          fs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Port of ``cheaptrick._windowed_frames`` after framing."""
    w = seg_raw.shape[-1]
    base = torch.arange(w, device=seg_raw.device) - w // 2
    half_len = torch.round(rdiv(1.5 * fs, f0)).to(torch.int64)
    mask = base.abs()[None, :] <= half_len[:, None]
    t = base.to(torch.float32) / fs
    win = 0.5 + 0.5 * torch.cos(math.pi * t[None, :] * f0[:, None] / 1.5)
    win = torch.where(mask, win, torch.zeros((), device=seg_raw.device))
    seg = seg_raw * win
    wsum = torch.sum(win, dim=-1, keepdim=True)
    seg = seg - win * (torch.sum(seg, dim=-1, keepdim=True)
                       / torch.clamp(wsum, min=1e-12))
    win_power = torch.clamp(torch.sum(win * win, dim=-1, keepdim=True),
                            min=1e-12)
    return seg, win_power


def windowed_frames(seg_raw: torch.Tensor, f0: torch.Tensor, fs: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, W] raw frames + [N] f0 (> 0) -> (windowed segments [N, W],
    window power [N, 1]).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises).
    """
    if (seg_raw.dim() != 2 or f0.shape != (seg_raw.shape[0],)
            or seg_raw.dtype != torch.float32 or f0.dtype != torch.float32):
        raise ValueError(f"windowed_frames needs seg [N, W] and f0 [N] "
                         f"float32, got {tuple(seg_raw.shape)} "
                         f"{seg_raw.dtype}, {tuple(f0.shape)} {f0.dtype}")
    if seg_raw.device.type == "cpu" and f0.device.type == "cpu":
        return windowed_frames_plain(seg_raw, f0, fs)
    if (seg_raw.device.type != "cuda" or f0.device != seg_raw.device
            or not seg_raw.is_contiguous() or not f0.is_contiguous()):
        raise ValueError("window kernel needs contiguous CUDA tensors on "
                         "one device")
    n, w = seg_raw.shape
    if w % 4 or w < 4 or seg_raw.data_ptr() % 16:
        raise ValueError(f"window kernel needs rows of a multiple of 4 "
                         f"floats on 16-byte aligned storage, got {w} at "
                         f"{seg_raw.data_ptr():#x}")
    out = torch.empty_like(seg_raw)
    wp = torch.empty((n, 1), dtype=torch.float32, device=seg_raw.device)
    _build.launch("tpuvc_windowed_frames", seg_raw.device,
                  seg_raw.data_ptr(),
                  f0.data_ptr(), out.data_ptr(), wp.data_ptr(), n, w,
                  float(fs))
    _build.count("window")
    return out, wp
