"""The decimator and the DIO/Harvest channel banks, on ``torch.fft``.

Port of ``tpuvc/dsp/filters.py`` (``decimate``, and ``lowpass_bank_fft``
and ``bandpass_bank_fft`` through ``_fir_bank_fft``), batched over
utterances.

Frozen plain copy of ``tpuvc_torch/dsp/filters.py`` for the benchmark's
reference: no hand kernel, nothing imported from the port.
"""

from __future__ import annotations

import math

import torch

from .arith import rdiv


def nuttall(i: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Nuttall window at positions ``i`` of a window of ``length`` taps."""
    x = 2.0 * math.pi * i / torch.clamp(length - 1, min=1)
    return (0.355768 - 0.487396 * torch.cos(x) + 0.144232 * torch.cos(2 * x)
            - 0.012604 * torch.cos(3 * x))


def decimate(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """Zero-phase FFT low-pass (content below 0.45 fs/ratio kept, raised-
    cosine rolloff from 0.9x the cutoff) + subsample: [B, T] -> [B, T']."""
    if ratio == 1:
        return x
    n = x.shape[-1]
    spec = torch.fft.rfft(x, dim=-1)
    freqs = torch.fft.rfftfreq(n, device=x.device)       # cycles/sample
    cutoff = 0.45 / ratio
    lo, hi = 0.9 * cutoff, cutoff
    gain = torch.clamp((hi - freqs) / (hi - lo), 0.0, 1.0)
    gain = 0.5 - 0.5 * torch.cos(math.pi * gain)
    if n % ratio == 0:
        # subsampling irfft_n(S)[::r] == irfft_{n/r} of the truncated
        # spectrum (the alias images carry only gain-zeroed bins), / r
        t_dec = n // ratio
        s_fold = (spec * gain)[..., :t_dec // 2 + 1]
        return torch.fft.irfft(s_fold, n=t_dec, dim=-1) / ratio
    y = torch.fft.irfft(spec * gain, n=n, dim=-1)
    return y[..., ::ratio]


def _fir_bank_fft(x: torch.Tensor, fs: float,
                  boundary_f0s: tuple[float, ...], periods_half: float,
                  modulate: bool, normalize_dc: bool) -> torch.Tensor:
    """A bank of Nuttall-windowed FIRs applied zero-phase in one batched
    FFT: x [B, T] -> [B, C, T].

    Channel c's FIR is a Nuttall window spanning ``2 * periods_half``
    periods of its boundary frequency bf, optionally modulated by
    cos(2 pi bf t) (band-pass) and optionally normalised to unit DC gain
    (low-pass).  All channels share a max-length tap grid (masked per
    channel), and each channel's group delay is removed as a phase ramp so
    event times line up across channels.
    """
    dev = x.device
    t_len = x.shape[-1]
    c = len(boundary_f0s)
    bounds = torch.tensor(boundary_f0s, dtype=torch.float32, device=dev)
    half = torch.round(rdiv(periods_half * fs, bounds)).to(torch.int64)
    fir_len = 2 * half + 1                                    # [C]
    max_len = int(2 * round(periods_half * fs / min(boundary_f0s)) + 1)
    pos = torch.arange(max_len, device=dev, dtype=torch.float32)[None, :]
    taps = nuttall(pos.expand(c, max_len), fir_len[:, None])
    if modulate:
        centered = pos - half[:, None].to(torch.float32)
        taps = taps * torch.cos(2.0 * math.pi * bounds[:, None] * centered
                                / fs)
    taps = torch.where(pos < fir_len[:, None], taps,
                       torch.zeros((), device=dev))
    if normalize_dc:
        taps = taps / torch.sum(taps, dim=-1, keepdim=True)
    nfft = 1
    while nfft < t_len + max_len:
        nfft *= 2
    xs = torch.fft.rfft(x, n=nfft, dim=-1)                    # [B, F]
    hs = torch.fft.rfft(taps, n=nfft, dim=-1)                 # [C, F]
    # group-delay removal as a phase ramp: y[t + delay_c]
    delay = torch.div(fir_len - 1, 2, rounding_mode="floor").to(
        torch.float32)
    kk = torch.arange(nfft // 2 + 1, dtype=torch.float32, device=dev)
    ph = (2.0 * math.pi / nfft) * kk[None, :] * delay[:, None]
    shift = torch.polar(torch.ones_like(ph), ph)
    y = torch.fft.irfft(xs[:, None, :] * hs[None] * shift[None], n=nfft,
                        dim=-1)
    return y[..., :t_len]


def bandpass_bank_fft(x: torch.Tensor, fs: float,
                      boundary_f0s: tuple[float, ...]) -> torch.Tensor:
    """Harvest's band-pass bank: x [B, T] -> [B, C, T].  Channel c is a
    Nuttall window over 4 periods of its boundary frequency bf modulated
    by cos(2 pi bf t), a band-pass centred at bf whose output's zero
    crossings track the fundamental when f0 ~ bf."""
    return _fir_bank_fft(x, fs, boundary_f0s, periods_half=2.0,
                         modulate=True, normalize_dc=False)


def lowpass_bank_fft(x: torch.Tensor, fs: float,
                     boundary_f0s: tuple[float, ...]) -> torch.Tensor:
    """DIO's low-pass bank: x [B, T] -> [B, C, T].  Channel c is a
    Nuttall window over 2 periods of its boundary f0, normalised to unit
    DC gain."""
    return _fir_bank_fft(x, fs, boundary_f0s, periods_half=1.0,
                         modulate=False, normalize_dc=True)
