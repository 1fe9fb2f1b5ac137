"""Vowel-like synthetic speech, made on the device from a seed.

A rewrite of ``tpuvc_torch/data/synthetic.py:synth_utterance`` (vibrato
f0, a two-formant envelope with a spectral tilt, breath noise, 20 ms
fades, peak 0.4) for a whole pool of utterances at once: every draw comes
from one ``torch.Generator`` on the device, in a few large calls, and the
harmonic sum runs in float64 there.  The draws are not the numpy
generator's, so the samples differ from that module's; the signal model
is the same.
"""

from __future__ import annotations

import math

import torch


def synth_pool(gen: torch.Generator, f0_base: torch.Tensor,
               formants: torch.Tensor, tilt_db: torch.Tensor,
               n_samples: torch.Tensor, fs: int) -> torch.Tensor:
    """Utterances [P, max(n_samples)] float32, zero past each length.

    ``f0_base`` [P] Hz, ``formants`` [P, 2] Hz, ``tilt_db`` [P] dB per
    octave, ``n_samples`` [P] int64: one row per utterance, on
    ``gen``'s device."""
    dev = gen.device
    f64 = torch.float64
    p = f0_base.shape[0]
    t_max = int(n_samples.max())
    f0_base = f0_base.to(dev, f64)[:, None]
    formants = formants.to(dev, f64)
    tilt = tilt_db.to(dev, f64)[:, None]
    n = n_samples.to(dev)[:, None]
    idx = torch.arange(t_max, device=dev)[None, :]
    t = idx.to(f64) / fs
    jitter = torch.randn((p, 1), generator=gen, device=dev, dtype=f64)
    f0 = f0_base * (1.0 + 0.03 * torch.sin(2 * math.pi * 2.5 * t)
                    + 0.02 * jitter)
    phase = 2 * math.pi * torch.cumsum(f0, dim=1) / fs
    n_harm = torch.floor(6000.0 / f0_base)                 # [P, 1]
    h_max = int(n_harm.max())
    phases = 2 * math.pi * torch.rand((p, h_max), generator=gen,
                                      device=dev, dtype=f64)
    x = torch.zeros((p, t_max), device=dev, dtype=f64)
    for h in range(1, h_max + 1):
        fh = h * f0_base
        g = sum(1.0 / (1.0 + ((fh - formants[:, j:j + 1]) / 300.0) ** 2)
                for j in range(2))
        g = (0.2 + g) * 10.0 ** (tilt * math.log2(h) / 20.0)
        g = torch.where(h <= n_harm, g / h ** 0.3, 0.0)
        x += g * torch.sin(h * phase + phases[:, h - 1:h])
    x += 0.01 * torch.randn((p, t_max), generator=gen, device=dev, dtype=f64)
    ramp_len = 0.02 * fs
    up = torch.clamp(idx / ramp_len, max=1.0)
    down = torch.clamp((n - 1 - idx) / ramp_len, min=0.0, max=1.0)
    x = torch.where(idx < n, x * up * down, 0.0)
    peak = torch.amax(torch.abs(x), dim=1, keepdim=True)
    return (0.4 * x / peak).to(torch.float32)
