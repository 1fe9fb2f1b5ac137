"""StoneMask f0 refinement, batched over utterances.

Port of ``tpuvc/dsp/stonemask.py:stonemask`` in the form of its
``_refine_once_fused``: per frame, the harmonic DFT kernel
(``tpuvc_torch/ops/harmonics.py``, one slot, with the derivative window,
folded) gives the spectrum and derivative spectrum at the first six
harmonics, and the refined f0 is the amplitude-weighted mean of the
harmonics' instantaneous frequencies.  Two passes; refinements that move
more than 20% from the input keep the input, unvoiced frames stay 0.
"""

from __future__ import annotations

import math

import torch

from tpuvc_torch.dsp.constants import (DEFAULT_WORLD, STONEMASK_FFT_SIZE,
                                       STONEMASK_NUM_HARMONICS,
                                       STONEMASK_RELATIVE_LIMIT)
from tpuvc_torch.ops.framing import frame_signal
from tpuvc_torch.ops.harmonics import fold_floor, harmonic_dft
from tpuvc_torch.utils.profiling import span

_FFT_SIZE = STONEMASK_FFT_SIZE


def _refine_once(raw_seg: torch.Tensor, f0: torch.Tensor,
                 fs: int) -> torch.Tensor:
    """One IF-refinement pass: raw_seg [N, W], f0 [N] -> [N]."""
    f0s = torch.clamp(f0, min=fold_floor(raw_seg.shape[-1], float(fs)))
    xre, xim, dre, dim_, _ = harmonic_dft(
        raw_seg, f0s[:, None].contiguous(), fs,
        n_harm=STONEMASK_NUM_HARMONICS, with_if=True, fold=True)
    xre, xim, dre, dim_ = (a[:, 0] for a in (xre, xim, dre, dim_))
    hh = torch.arange(1, STONEMASK_NUM_HARMONICS + 1, dtype=torch.float32,
                      device=f0.device)
    power = xre * xre + xim * xim + 1e-12
    inst = hh * f0s[:, None] + (xre * dim_ - xim * dre) / power * (
        fs / (2.0 * math.pi))
    amp = torch.where(hh * f0s[:, None] < fs / 2.0, torch.sqrt(power), 0.0)
    num = torch.sum(amp * inst / hh, dim=-1)
    den = torch.sum(amp, dim=-1)
    return torch.where(den > 0, num / torch.clamp(den, min=1e-12), f0)


def stonemask(x: torch.Tensor, f0: torch.Tensor,
              hop: int = DEFAULT_WORLD.hop,
              fs: int = DEFAULT_WORLD.fs) -> torch.Tensor:
    """Refine a DIO track: x [B, T], f0 [B, N] -> [B, N]."""
    x = x.to(torch.float32)
    f0 = f0.to(torch.float32)
    bsz, n = f0.shape
    with span("stonemask"):
        raw_seg = frame_signal(x, hop, _FFT_SIZE, n).reshape(bsz * n,
                                                             _FFT_SIZE)
        flat = f0.reshape(-1)
        refined = _refine_once(raw_seg, flat, fs)
        refined = _refine_once(raw_seg, refined, fs).reshape(bsz, n)
        rel = torch.abs(refined - f0) / torch.clamp(f0, min=1e-6)
        good = (f0 > 0) & (rel <= STONEMASK_RELATIVE_LIMIT) & (refined > 0)
        return torch.where(f0 > 0, torch.where(good, refined, f0), 0.0)
