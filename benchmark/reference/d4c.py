"""D4C band aperiodicity, batched over utterances.

Port of ``tpuvc/dsp/d4c.py:d4c``.  ``method="group_delay"`` (the default,
WORLD's statistic):

  1. LoveTrain voicing guard: a 3-period Hanning window's power in
     [100 Hz, 4 kHz] over [100 Hz, 7.9 kHz]; at or below 0.85 the frame is
     fully aperiodic.
  2. static centroid: two unit-energy 4-period Blackman windows at
     t +- 1/(4 f0); C(k) = Re{X* Y} with Y = FFT(t x_w(t)), summed over the
     two offsets and DC-corrected.
  3. smoothed power: a 4-period Hanning window's power, DC-corrected and
     box-smoothed over f0 (up to ``max_refined_f0()`` = 1056 Hz).
  4. static group delay = centroid / power, minus its own f0/2-wide box
     smoothing (a signed input: no floor).
  5. per 3 kHz band: a Nuttall-windowed segment of it, its power
     spectrum, and the share of power NOT in the top round(fft*8/len)
     coefficients (the top-k sum kernel, ``tpuvc_torch/ops/topk.py``),
     in dB, plus (f0 - 100)/50 dB, clamped to [-60, 0].

The four windows come from one cos/sin grid (``_all_windows``); the six
forward transforms are one batched FFT.  The JAX module runs them as a
two-stage Cooley-Tukey matmul DFT (``rdft_ct``) to cap float32
accumulation depth on the TPU; an FFT accumulates that way already.

``method="nccf"`` (``_nccf_coarse``): a Hanning window over +-2 periods,
the power spectrum, and per band 1 - the band-limited normalised
autocorrelation at lag fs/f0; a low-band periodicity at or below 0.15
marks the frame fully aperiodic.

Either way the coarse values are interpolated in dB over the output bins.

Frozen plain copy of ``tpuvc_torch/dsp/d4c.py`` for the benchmark's
reference: no hand kernel, nothing imported from the port.
"""

from __future__ import annotations

import math

import torch

from .constants import (D4C_CEIL_DB, D4C_FLOOR_DB,
                                       D4C_FREQUENCY_INTERVAL,
                                       D4C_THRESHOLD,
                                       D4C_UNVOICED_PLACEHOLDER_F0,
                                       DEFAULT_WORLD, d4c_fft_size,
                                       d4c_num_bands, max_refined_f0)
from .interp import interp_uniform
from .spectral import dc_correction, linear_smoothing
from .arith import rdiv
from .dft import rdft, rdft_power
from .framing import frame_signal
from .topk import topk_sum


def _nuttall(n: int, device) -> torch.Tensor:
    t = torch.arange(n, dtype=torch.float32, device=device) * (
        2.0 * math.pi / (n - 1))
    return (0.355768 - 0.487396 * torch.cos(t) + 0.144232 * torch.cos(2 * t)
            - 0.012604 * torch.cos(3 * t))


def _love_ratio(ps: torch.Tensor, fs: int, fft_size: int) -> torch.Tensor:
    """[N] low-band power concentration (voiced ~1, noise ~0.5)."""
    df = fs / fft_size
    b0 = math.ceil(100.0 / df)
    b1 = math.ceil(4000.0 / df)
    b2 = math.ceil(min(7900.0, fs / 2.0 - df) / df)
    num = torch.sum(ps[:, b0:b1 + 1], dim=-1)
    den = num + torch.sum(ps[:, b1 + 1:b2 + 1], dim=-1)
    return num / torch.clamp(den, min=1e-20)


def _coarse_band_ap(sgd: torch.Tensor, fs: int, fft_size: int,
                    n_bands: int) -> torch.Tensor:
    """Sorted-power concentration per 3 kHz band -> [N, n_bands] dB."""
    wl = int(D4C_FREQUENCY_INTERVAL * fft_size / fs) * 2 + 1
    window = _nuttall(wl, sgd.device)
    boundary = round(fft_size * 8.0 / wl)
    segs = []
    for b in range(n_bands):
        center = int(D4C_FREQUENCY_INTERVAL * (b + 1) * fft_size / fs)
        lo = center - wl // 2
        segs.append(sgd[:, lo:lo + wl] * window[None])
    ps = rdft_power(torch.cat(segs, dim=0), fft_size, fft_size // 2)
    total = torch.sum(ps, dim=-1)
    top = topk_sum(ps, boundary)
    ratio = torch.clamp(1.0 - top / torch.clamp(total, min=1e-30), 1e-12,
                        1.0)
    db = 10.0 * torch.log10(ratio)
    return db.reshape(n_bands, sgd.shape[0]).T


def _all_windows(seg: torch.Tensor, f0: torch.Tensor, fs: int):
    """The four pitch-adaptive windows of the group-delay path from one
    cos/sin grid: with theta = 2 pi b f0 / (12 fs), the Hanning-3 window
    needs cos(4 theta), the Hanning-4 cos(3 theta), and the two shifted
    Blackman-4 windows cos(3 theta -+ delta) and cos(6 theta -+ 2 delta),
    delta = 2 pi shift f0 / (4 fs) a per-frame scalar.  seg [N, D], f0
    [N] -> (w_lt, w_c1, w_c2, w_p, shift1, shift2)."""
    d = seg.shape[-1]
    b = (torch.arange(d, dtype=torch.float32, device=seg.device)
         - d // 2)[None, :]
    f0c = f0[:, None]
    theta = 2.0 * math.pi * b * f0c / (12.0 * fs)
    c = torch.cos(theta)
    s = torch.sin(theta)
    cc = c * c
    c2 = 2.0 * cc - 1.0
    c3 = c * (4.0 * cc - 3.0)
    s3 = s * (3.0 - 4.0 * s * s)
    c4 = 2.0 * c2 * c2 - 1.0
    c6 = 2.0 * c3 * c3 - 1.0
    s6 = 2.0 * s3 * c3

    zero = torch.zeros((), device=seg.device)
    hl3 = torch.round(rdiv(1.5 * fs, f0c))
    hl4 = torch.round(rdiv(2.0 * fs, f0c))
    w_lt = torch.where(torch.abs(b) <= hl3, 0.5 + 0.5 * c4, zero)
    w_p = torch.where(torch.abs(b) <= hl4, 0.5 + 0.5 * c3, zero)

    shift1 = torch.round(rdiv(-0.25 * fs, f0))                 # [N]
    delta = 2.0 * math.pi * shift1[:, None] * f0c / (4.0 * fs)
    cd, sd = torch.cos(delta), torch.sin(delta)                # [N, 1]
    c2d = 2.0 * cd * cd - 1.0
    s2d = 2.0 * sd * cd

    def blackman(sgn):  # cos(3t -+ d), cos(6t -+ 2d): shift2 = -shift1
        return (0.42 + 0.5 * (c3 * cd + sgn * s3 * sd)
                + 0.08 * (c6 * c2d + sgn * s6 * s2d))

    w_c1 = torch.where(torch.abs(b - shift1[:, None]) <= hl4, blackman(1.0),
                       zero)
    w_c2 = torch.where(torch.abs(b + shift1[:, None]) <= hl4,
                       blackman(-1.0), zero)
    return w_lt, w_c1, w_c2, w_p, shift1, -shift1


def _apply_window(seg: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """seg * w with WORLD's weighted-mean removal."""
    wave = seg * w
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    return wave - w * (torch.sum(wave, dim=-1, keepdim=True) / wsum)


def _unit_energy(wave: torch.Tensor) -> torch.Tensor:
    return wave / torch.sqrt(torch.clamp(
        torch.sum(wave * wave, dim=-1, keepdim=True), min=1e-30))


def _group_delay_coarse(x, f0, hop, fs, n_bands):
    """Coarse band aperiodicities [N, n_bands] (dB) + LoveTrain [N];
    f0 [B, N] flattened to N = B*frames."""
    d = d4c_fft_size(fs)
    bsz, n = f0.shape
    seg = frame_signal(x, hop, d, n).reshape(bsz * n, d)
    f0 = f0.reshape(-1)
    b = (torch.arange(d, dtype=torch.float32, device=seg.device)
         - d // 2)[None, :]

    w_lt, w_c1, w_c2, w_p, shift1, shift2 = _all_windows(seg, f0, fs)
    hl4 = torch.round(rdiv(2.0 * fs, f0))[:, None]
    wave_c1 = _unit_energy(_apply_window(seg, w_c1))
    wave_c2 = _unit_energy(_apply_window(seg, w_c2))
    const1 = hl4 - shift1[:, None]
    const2 = hl4 - shift2[:, None]
    stacked = torch.cat([_apply_window(seg, w_lt), wave_c1, wave_c1 * b,
                         wave_c2, wave_c2 * b, _apply_window(seg, w_p)])
    del seg, w_lt, w_c1, w_c2, w_p
    re, im = rdft(stacked, d)
    rows = bsz * n
    lt_re, x1_re, y1b_re, x2_re, y2b_re, p_re = re.split(rows)
    lt_im, x1_im, y1b_im, x2_im, y2b_im, p_im = im.split(rows)

    love = _love_ratio(lt_re * lt_re + lt_im * lt_im, fs, d)
    # Y = FFT(wave * b) + const * X; C = Re{X* Y} over both offsets
    cent = (x1_re * (y1b_re + const1 * x1_re)
            + x1_im * (y1b_im + const1 * x1_im)
            + x2_re * (y2b_re + const2 * x2_re)
            + x2_im * (y2b_im + const2 * x2_im))
    ps = p_re * p_re + p_im * p_im
    del re, im, stacked

    both = dc_correction(torch.cat([ps, cent]), torch.cat([f0, f0]), fs, d)
    ps, cent = both[:rows], both[rows:]
    # width f0 can reach max_refined_f0() (1056 Hz); the default 810 Hz
    # cap would truncate the box and deflate the smoothed power
    ps = linear_smoothing(ps.contiguous(), f0, fs, d,
                          max_width_hz=max_refined_f0())
    sgd = cent / torch.clamp(ps, min=1e-30)
    sgd = sgd - linear_smoothing(sgd, f0 / 2.0, fs, d, floor_rel=None)

    coarse = _coarse_band_ap(sgd, fs, d, n_bands)
    coarse = torch.clamp(coarse + ((f0 - 100.0) / 50.0)[:, None],
                         D4C_FLOOR_DB, 0.0)
    return coarse, love


_NCCF_FFT_SIZE = 2048


def _windowed(seg: torch.Tensor, f0: torch.Tensor, fs: int,
              periods: float) -> torch.Tensor:
    """Pitch-adaptive Hanning window with weighted-mean removal:
    seg [N, D], f0 [N] -> windowed segment [N, D]."""
    d = seg.shape[-1]
    b = (torch.arange(d, dtype=torch.float32, device=seg.device)
         - d // 2)[None, :]
    half_len = torch.round(rdiv(periods / 2.0 * fs, f0))[:, None]
    ph = 2.0 * math.pi * b * f0[:, None] / (periods * fs)
    w = 0.5 + 0.5 * torch.cos(ph)
    w = torch.where(torch.abs(b) <= half_len, w, 0.0)
    wave = seg * w
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    return wave - w * (torch.sum(wave, dim=-1, keepdim=True) / wsum)


def _windowed_power_spectrum(x, f0, hop, fs):
    bsz, n = f0.shape
    seg = frame_signal(x, hop, _NCCF_FFT_SIZE, n).reshape(
        bsz * n, _NCCF_FFT_SIZE)
    wave = _windowed(seg, f0.reshape(-1), fs, 4.0)
    wave = wave - torch.mean(wave, dim=-1, keepdim=True)
    spec = torch.fft.rfft(wave, n=_NCCF_FFT_SIZE, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def _band_periodicity(ps, f0, fs, lo_hz, hi_hz):
    """Normalised band-limited autocorrelation at lag fs/f0: ps [N, K],
    f0 [N] -> [N]."""
    k = ps.shape[-1]
    freqs = torch.arange(k, dtype=torch.float32, device=ps.device) * (
        fs / _NCCF_FFT_SIZE)
    band = ((freqs >= lo_hz) & (freqs < hi_hz)).to(ps.dtype)
    ac = torch.fft.irfft(ps * band[None, :], n=_NCCF_FFT_SIZE, dim=-1)
    lag = rdiv(fs, torch.clamp(f0, min=1.0))
    r = interp_uniform(ac, lag[:, None])[:, 0] / torch.clamp(ac[:, 0],
                                                             min=1e-20)
    return torch.clamp(r, 0.0, 1.0)


def _nccf_coarse(x, f0, hop, fs, n_bands):
    """Coarse band aperiodicities [N, n_bands] (dB) + low-band
    periodicity [N]; f0 [B, N] flattened to N = B*frames."""
    ps = _windowed_power_spectrum(x, f0, hop, fs)
    flat = f0.reshape(-1)
    r_low = _band_periodicity(ps, flat, fs, 60.0, D4C_FREQUENCY_INTERVAL)
    love = torch.sqrt(torch.clamp(r_low, 0.0, 1.0))
    coarse = []
    for b in range(n_bands):
        lo = D4C_FREQUENCY_INTERVAL * (b + 0.5)
        hi = D4C_FREQUENCY_INTERVAL * (b + 1.5)
        r = _band_periodicity(ps, flat, fs, lo, hi)
        coarse.append(10.0 * torch.log10(torch.clamp(1.0 - r, 1e-12, 1.0)))
    coarse_db = (torch.stack(coarse, dim=-1) if coarse
                 else flat.new_zeros((flat.shape[0], 0)))
    return coarse_db, love


def d4c(x: torch.Tensor, f0: torch.Tensor, hop: int = DEFAULT_WORLD.hop,
        fs: int = DEFAULT_WORLD.fs, fft_size: int = DEFAULT_WORLD.fft_size,
        method: str = "group_delay") -> torch.Tensor:
    """Aperiodicity (amplitude ratio) per frame and bin: x [B, T],
    f0 [B, N] (0 = unvoiced) -> [B, N, fft_size//2 + 1]."""
    if method not in ("group_delay", "nccf"):
        raise ValueError(f"unknown d4c method {method!r}")
    x = x.to(torch.float32)
    f0 = f0.to(torch.float32)
    bsz, n = f0.shape
    half = fft_size // 2 + 1
    n_bands = d4c_num_bands(fs)
    f0_eff = torch.where(f0 > 0, f0, D4C_UNVOICED_PLACEHOLDER_F0)
    if method == "group_delay":
        coarse_db, love = _group_delay_coarse(x, f0_eff, hop, fs, n_bands)
        threshold = D4C_THRESHOLD
    else:
        coarse_db, love = _nccf_coarse(x, f0_eff, hop, fs, n_bands)
        threshold = 1.0 - D4C_THRESHOLD
    fully_ap = (~(f0.reshape(-1) > 0)) | (love <= threshold)

    dev = x.device
    node_freqs = torch.cat([
        torch.zeros(1, device=dev),
        torch.arange(1, n_bands + 1, dtype=torch.float32, device=dev)
        * D4C_FREQUENCY_INTERVAL,
        torch.full((1,), fs / 2.0, device=dev)])
    rows = coarse_db.shape[0]
    node_vals = torch.cat([
        torch.full((rows, 1), D4C_FLOOR_DB, device=dev), coarse_db,
        torch.full((rows, 1), D4C_CEIL_DB, device=dev)], dim=-1)
    freqs = torch.arange(half, dtype=torch.float32, device=dev) * (
        fs / fft_size)
    j = torch.clamp(torch.searchsorted(node_freqs, freqs, right=True) - 1,
                    0, node_freqs.shape[0] - 2)
    w = ((freqs - node_freqs[j])
         / torch.clamp(node_freqs[j + 1] - node_freqs[j], min=1e-6))
    ap_db = (node_vals[:, j] * (1.0 - w)[None, :]
             + node_vals[:, j + 1] * w[None, :])
    ap = torch.pow(10.0, ap_db / 20.0)
    ap = torch.where(fully_ap[:, None], 1.0 - 1e-12, ap)
    return torch.clamp(ap, 1e-8, 1.0 - 1e-12).reshape(bsz, n, half)
