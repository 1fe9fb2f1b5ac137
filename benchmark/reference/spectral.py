"""DC correction and box smoothing of half spectra.

Port of ``tpuvc/dsp/spectral.py``.  ``dc_correction`` mirrors the
spectrum around f0 onto the bins below f0 as a fractional shift of its
even periodic extension (one forward and one inverse cosine transform).
``linear_smoothing`` is WORLD's rectangle-rule box average; it goes
through the box-smoothing kernel (``tpuvc_torch/ops/smooth.py``).

Frozen plain copy of ``tpuvc_torch/dsp/spectral.py`` for the benchmark's
reference: no hand kernel, nothing imported from the port.
"""

from __future__ import annotations

import math

import torch

from .dft import cos_fwd, cos_inv2
from .smooth import box_smooth


def dc_correction(ps: torch.Tensor, f0: torch.Tensor, fs: int,
                  fft_size: int) -> torch.Tensor:
    """Add the spectrum mirrored around f0 to the bins below f0:
    ps [N, half], f0 [N]."""
    half = fft_size // 2 + 1
    df = fs / fft_size
    m = torch.arange(half, dtype=ps.dtype, device=ps.device)
    freq = m * df
    c = cos_fwd(ps)
    q = (f0 / df)[:, None]                                   # shift in bins
    phi = 2.0 * math.pi * (m[None, :] * q) / fft_size
    replica = cos_inv2(c * torch.cos(phi), -c * torch.sin(phi))
    replica = torch.clamp(replica, min=0.0)   # band-limited shift may ring
    below = freq[None, :] < f0[:, None]
    return torch.where(below, ps + replica, ps)


def linear_smoothing(ps: torch.Tensor, width: torch.Tensor, fs: int,
                     fft_size: int, floor_rel: float | None = 1e-9,
                     max_width_hz: float = 810.0) -> torch.Tensor:
    """Box-smooth ps [N, half] with per-frame width [N] (Hz, clamped to
    ``max_width_hz``); floor non-negative inputs at ``floor_rel`` of the
    frame peak (``None`` for signed inputs)."""
    sm = box_smooth(ps, width, fs, fft_size, max_width_hz)
    if floor_rel is None:
        return sm
    floor = torch.amax(sm, dim=-1, keepdim=True) * floor_rel
    return torch.maximum(sm, floor)
