"""Per-frame rectangular (box) smoothing of a half spectrum.

Replaces ``tpuvc/ops/pallas_smooth.py:box_smooth_pallas`` (the Pallas
``_kernel``): WORLD's LinearSmoothing, (1/w) * the integral of the
piecewise-constant spectrum over [f - w/2, f + w/2] with even reflection
at DC and Nyquist, as a direct sum over the 2K+1 bins any window up to
``max_width_hz`` can touch, K = int(max_width_hz / (2 df)) + 2 (55 taps at
810 Hz).  It stays a direct sum: a cumulative-sum difference or an FFT
lifts the noise floor about 60 dB in -120 dB valleys
(``tpuvc/dsp/spectral.py:linear_smoothing``).

CUDA kernel (``csrc/smooth.cu``): one warp per frame, eight frames per
block.  The warp stages the frame's mirror-extended row in shared memory
straight from ``ps`` (the index map of :func:`mirror_extend`, so the card
path builds no extended copy) and computes the 2K+1 weights; each lane
sums 17 consecutive bins in registers over the span from the frame's
first to its last nonzero weight only, in order o = -K..K, products and
sums rounded separately as here, so kernel and plain version agree bit
for bit on finite spectra.  Bound: bytes (each row read once and written
once); the first design, one thread per bin over all 2K+1 taps with two
shared-memory reads per tap and the extended row built by a separate
pass, ran at 11-14% of it (PERF.md).

The plain version is the port of the XLA twin in
``tpuvc/dsp/spectral.py:linear_smoothing`` (lines 89-103).
"""

from __future__ import annotations

import torch

from tpuvc_torch.ops import _build


def n_taps_half(fs: int, fft_size: int, max_width_hz: float) -> int:
    return int(max_width_hz / (2.0 * (fs / fft_size))) + 2


def mirror_extend(ps: torch.Tensor, k: int) -> torch.Tensor:
    """[N, half] -> [N, half + 2k]: ps[k..1] | ps | ps[half-2..half-1-k]."""
    half = ps.shape[-1]
    return torch.cat([ps[:, 1:k + 1].flip(-1), ps,
                      ps[:, half - 1 - k:half - 1].flip(-1)], dim=-1)


def box_weights(width: torch.Tensor, fs: int, fft_size: int,
                max_width_hz: float) -> torch.Tensor:
    """[N] widths (Hz) -> [N, 2K+1] overlap weights of each frame's box,
    box_smooth_plain's for all taps at once (the kernel sums only the span
    of nonzero ones)."""
    df = fs / fft_size
    k = n_taps_half(fs, fft_size, max_width_hz)
    w = torch.clamp(width, max=max_width_hz)[:, None]
    o = torch.arange(-k, k + 1, dtype=torch.float64, device=width.device)
    lo = torch.maximum(-0.5 * w, (o * df - 0.5 * df).float())
    hi = torch.minimum(0.5 * w, (o * df + 0.5 * df).float())
    return torch.clamp(hi - lo, min=0.0) / w


def box_smooth_plain(ps: torch.Tensor, width: torch.Tensor, fs: int,
                     fft_size: int, max_width_hz: float) -> torch.Tensor:
    df = fs / fft_size
    k = n_taps_half(fs, fft_size, max_width_hz)
    width = torch.clamp(width, max=max_width_hz)
    w = width[:, None]
    ext = mirror_extend(ps, k)
    half = ps.shape[-1]
    sm = torch.zeros_like(ps)
    for o in range(-k, k + 1):
        # overlap of [-w/2, w/2] with bin o's cell [(o-.5) df, (o+.5) df]
        lo = torch.clamp(-0.5 * w, min=o * df - 0.5 * df)
        hi = torch.clamp(0.5 * w, max=o * df + 0.5 * df)
        wgt = torch.clamp(hi - lo, min=0.0) / w
        sm = sm + ext[:, k + o:k + o + half] * wgt
    return sm


def box_smooth(ps: torch.Tensor, width: torch.Tensor, fs: int,
               fft_size: int, max_width_hz: float) -> torch.Tensor:
    """[N, half] spectrum + [N] width (Hz) -> box-smoothed [N, half].

    Widths are clamped to ``max_width_hz``.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises).
    """
    half = fft_size // 2 + 1
    if (ps.dim() != 2 or ps.shape[1] != half or width.shape != (ps.shape[0],)
            or ps.dtype != torch.float32 or width.dtype != torch.float32):
        raise ValueError(f"box_smooth needs ps [N, {half}] and width [N] "
                         f"float32, got {tuple(ps.shape)} {ps.dtype}, "
                         f"{tuple(width.shape)} {width.dtype}")
    if ps.device.type == "cpu" and width.device.type == "cpu":
        return box_smooth_plain(ps, width, fs, fft_size, max_width_hz)
    if ps.device.type != "cuda" or width.device != ps.device:
        raise ValueError("smoothing kernel needs CUDA tensors on one device")
    k = n_taps_half(fs, fft_size, max_width_hz)
    if k >= half - 1:
        raise ValueError(f"max_width_hz {max_width_hz} too wide for "
                         f"fft_size {fft_size}")
    ps, width = ps.contiguous(), width.contiguous()
    out = torch.empty_like(ps)
    _build.launch("tpuvc_box_smooth", ps.device, ps.data_ptr(),
                  width.data_ptr(), out.data_ptr(), ps.shape[0], half, k,
                  float(fs / fft_size), float(max_width_hz))
    _build.count("smooth")
    return out
