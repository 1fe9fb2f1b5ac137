"""CheapTrick spectral envelope, batched over utterances.

Port of ``tpuvc/dsp/cheaptrick.py:cheaptrick``: pitch-adaptive windowing
(window kernel, ``tpuvc_torch/ops/window.py``), the power spectrum
normalised by the window power, a deterministic safeguard floor, DC
correction, box smoothing of width 2 f0 / 3 (smoothing kernel), and the
cepstral lifter.  Returns the power spectral envelope (pyworld's ``sp``).

A frame that holds a NaN or inf anywhere gives an all-NaN row, as in the
reference, whose windowing multiplies every sample by its window (x * 0 is
NaN) before the mean.  The window kernel reads only the support, so the
frame's flag comes from the waveform (``ops/framing.py:nonfinite_frames``)
and reaches every bin through the window-power divisor of the spectrum.

Frozen plain copy of ``tpuvc_torch/dsp/cheaptrick.py`` for the benchmark's
reference: no hand kernel, nothing imported from the port.
"""

from __future__ import annotations

import math

import torch

from .constants import (CHEAPTRICK_DEFAULT_F0,
                                       CHEAPTRICK_Q1, DEFAULT_WORLD,
                                       SAFE_GUARD_MINIMUM)
from .spectral import dc_correction, linear_smoothing
from .dft import cos_fwd, cos_inv, rdft_power
from .framing import frame_signal, nonfinite_frames
from .window import windowed_frames


def _lifter(log_ps_half: torch.Tensor, f0: torch.Tensor, fs: int,
            fft_size: int, q1: float) -> torch.Tensor:
    """Smoothing lifter x compensation lifter on the even cepstrum."""
    cep = cos_inv(log_ps_half)
    half = fft_size // 2 + 1
    q = torch.arange(half, dtype=log_ps_half.dtype,
                     device=log_ps_half.device)[None, :] / fs
    arg = math.pi * f0[:, None] * q
    lifter_s = torch.where(arg > 1e-6,
                           torch.sin(arg) / torch.clamp(arg, min=1e-6), 1.0)
    lifter_c = (1.0 - 2.0 * q1) + 2.0 * q1 * torch.cos(2.0 * arg)
    return cos_fwd(cep * lifter_s * lifter_c)


def cheaptrick(x: torch.Tensor, f0: torch.Tensor,
               hop: int = DEFAULT_WORLD.hop, fs: int = DEFAULT_WORLD.fs,
               fft_size: int = DEFAULT_WORLD.fft_size) -> torch.Tensor:
    """x [B, T], f0 [B, N] -> power spectral envelope [B, N, fft//2+1].

    Frames whose f0 is below the FFT's low limit (unvoiced included) use
    the WORLD default envelope f0 of 500 Hz."""
    x = x.to(torch.float32)
    f0 = f0.to(torch.float32)
    bsz, n = f0.shape
    f0_low_limit = 3.0 * fs / (fft_size - 3.0)
    f0_eff = torch.where(f0 <= f0_low_limit, CHEAPTRICK_DEFAULT_F0,
                         f0).reshape(-1)
    seg_raw = frame_signal(x, hop, fft_size, n).reshape(bsz * n, fft_size)
    seg, win_power = windowed_frames(seg_raw, f0_eff, fs)
    nan_rows = torch.where(nonfinite_frames(x, hop, fft_size, n), math.nan,
                           0.0).reshape(-1, 1)
    ps = rdft_power(seg, fft_size) / (win_power + nan_rows)
    floor = torch.amax(ps, dim=-1, keepdim=True) * 1e-12 + SAFE_GUARD_MINIMUM
    ps = ps + floor
    ps = dc_correction(ps, f0_eff, fs, fft_size)
    ps = linear_smoothing(ps, 2.0 * f0_eff / 3.0, fs, fft_size)
    env = _lifter(torch.log(ps), f0_eff, fs, fft_size, CHEAPTRICK_Q1)
    return torch.exp(env).reshape(bsz, n, -1)
