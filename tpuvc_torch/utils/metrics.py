"""Quality metrics: mel-cepstral distortion (MCD) + sharpness metrics.

The port's own copy of ``tpuvc/utils/metrics.py``: numpy float64 on the
host, as in the JAX package, so the port's figures read the same as its
(``mcd_dtw``'s DP row recursion is serial: on the card it would cost one
launch per row).

MCD is the project's parity currency (BASELINE.md: 'MCD within 0.1 dB'):
mel-cepstral coefficient sequences derived from the spectral envelopes —
log-mel filterbank energies -> DCT-II -> coefficients 1..order (c0
excluded), MCD = (10/ln10) * sqrt(2 * sum (dc_k)^2), averaged over frames.
The mel-cepstra here come from a mel filterbank rather than SPTK's
all-pass-warped mel-cepstrum, which is a fixed linear map of the same
envelope — consistent across compared systems.

Sharpness metrics (VERDICT r3 item 3 — the axis the VAW-GAN critic exists
for: the paper motivates the GAN term by reduced over-smoothing, which MCD
cannot see):

  - mel-cepstral GLOBAL VARIANCE (Toda et al. 2007): per-coefficient
    variance of the MCC trajectories over frames.  Statistical-model
    over-smoothing collapses GV well below natural speech; gv_ratio_db
    reports 10*log10(gv_test / gv_ref) averaged over coefficients (0 dB =
    as sharp as the reference, negative = over-smoothed).
  - MODULATION SPECTRUM (Takamichi et al. 2014): power spectrum of each
    MCC trajectory over time.  Over-smoothing specifically attenuates the
    higher modulation bands (> ~10 Hz); ms_highband_ratio_db reports the
    test/reference power ratio in those bands.
"""

from __future__ import annotations

import numpy as np

_LN10 = np.log(10.0)


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_bins: int, fs: int) -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_bins] over rfft bins."""
    f_bins = np.linspace(0.0, fs / 2.0, n_bins)
    m_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(fs / 2.0), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    fb = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lo, ce, hi = f_pts[i], f_pts[i + 1], f_pts[i + 2]
        up = (f_bins - lo) / max(ce - lo, 1e-6)
        down = (hi - f_bins) / max(hi - ce, 1e-6)
        fb[i] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


def mel_cepstrum(sp: np.ndarray, fs: int, order: int = 24,
                 n_mels: int = 40) -> np.ndarray:
    """[T, n_bins] power envelope -> [T, order] mel-cepstra (c1..c_order).

    Coefficients are from the log-AMPLITUDE spectrum (0.5 ln power), the
    standard MCD convention.
    """
    fb = mel_filterbank(n_mels, sp.shape[-1], fs)
    logmel = 0.5 * np.log(np.maximum(sp @ fb.T, 1e-20))
    # DCT-II, orthogonal
    k = np.arange(n_mels)
    dct = np.cos(np.pi * np.outer(np.arange(1, order + 1), 2 * k + 1)
                 / (2 * n_mels)) * np.sqrt(2.0 / n_mels)
    return logmel @ dct.T


def mel_cepstral_gv(sp: np.ndarray, fs: int,
                    order: int = 24) -> np.ndarray:
    """Per-coefficient global variance of the mel-cepstra: [order].

    Computed over all frames of one (or several concatenated) utterances;
    voiced/unvoiced are pooled, matching the usual GV evaluation.
    """
    c = mel_cepstrum(sp, fs, order)
    return np.var(c, axis=0)


def gv_ratio_db(sp_test: np.ndarray, sp_ref: np.ndarray, fs: int,
                order: int = 24) -> float:
    """Mean over coefficients of 10*log10(GV_test / GV_ref) in dB.

    0 dB = the test envelopes carry natural spectral variance; strongly
    negative = over-smoothed (the failure mode the VAW-GAN critic
    targets).  Frame alignment is NOT required — GV is a distributional
    statistic.
    """
    gv_t = mel_cepstral_gv(sp_test, fs, order)
    gv_r = mel_cepstral_gv(sp_ref, fs, order)
    return float(np.mean(10.0 * np.log10(
        np.maximum(gv_t, 1e-12) / np.maximum(gv_r, 1e-12))))


def modulation_spectrum(sp: np.ndarray, fs: int, order: int = 24,
                        frame_period_s: float = 0.005,
                        n_fft: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Per-coefficient modulation power spectrum of the MCC trajectories.

    Returns (freqs [n_fft//2+1] in Hz of modulation, power [n_mod_bins,
    order]).  Trajectories are mean-removed, Hann-windowed over segments
    of n_fft frames (50% overlap, Welch-averaged) — over-smoothing shows
    up as a high-band power deficit.
    """
    c = mel_cepstrum(sp, fs, order)
    c = c - c.mean(axis=0, keepdims=True)
    t = len(c)
    seg = min(n_fft, t)
    hop = max(1, seg // 2)
    win = np.hanning(seg)[:, None]
    segs = []
    for lo in range(0, max(1, t - seg + 1), hop):
        segs.append(np.abs(np.fft.rfft(c[lo: lo + seg] * win,
                                       n=n_fft, axis=0)) ** 2)
    power = np.mean(segs, axis=0)
    freqs = np.fft.rfftfreq(n_fft, d=frame_period_s)
    return freqs, power


def ms_highband_ratio_db(sp_test: np.ndarray, sp_ref: np.ndarray, fs: int,
                         order: int = 24, cutoff_hz: float = 10.0,
                         frame_period_s: float = 0.005) -> float:
    """Test/reference modulation power ratio above ``cutoff_hz``, in dB.

    The high modulation bands carry the fast spectral transitions that
    statistical over-smoothing blurs first (Takamichi et al. 2014);
    0 dB = parity with the reference envelopes.
    """
    f_t, p_t = modulation_spectrum(sp_test, fs, order,
                                   frame_period_s=frame_period_s)
    f_r, p_r = modulation_spectrum(sp_ref, fs, order,
                                   frame_period_s=frame_period_s)
    hi_t = p_t[f_t >= cutoff_hz].mean()
    hi_r = p_r[f_r >= cutoff_hz].mean()
    return float(10.0 * np.log10(max(hi_t, 1e-20) / max(hi_r, 1e-20)))


def mcd(sp_a: np.ndarray, sp_b: np.ndarray, fs: int,
        order: int = 24) -> float:
    """Frame-averaged mel-cepstral distortion in dB between two
    [T, n_bins] power-envelope sequences (equal T; no DTW — frames are
    time-aligned in this pipeline)."""
    ca = mel_cepstrum(sp_a, fs, order)
    cb = mel_cepstrum(sp_b, fs, order)
    t = min(len(ca), len(cb))
    d = ca[:t] - cb[:t]
    per_frame = (10.0 / _LN10) * np.sqrt(
        2.0 * np.sum(d * d, axis=-1))
    return float(per_frame.mean())


def mcd_dtw(sp_a: np.ndarray, sp_b: np.ndarray, fs: int,
            order: int = 24) -> float:
    """DTW-aligned mel-cepstral distortion in dB (the convention VC
    evaluations report for non-time-aligned pairs, e.g. a conversion vs
    the target speaker's parallel recording, whose timings differ).

    Sakoe-Chiba SYMMETRIC DTW (diagonal steps weighted 2, up/left 1,
    total normalized by T_a + T_b — the classical normalization whose
    weight sum is path-independent).  Each DP row vectorizes exactly:
    the left-step recursion acc[j] = min(m[j], acc[j-1] + d[j]) unrolls
    to acc[j] = S[j] + min_{k<=j}(m[k] - S[k]) with S the row prefix sum
    — one cumsum + one running min per row, O(T_a * T_b) total.
    """
    ca = mel_cepstrum(sp_a, fs, order)
    cb = mel_cepstrum(sp_b, fs, order)
    # per-pair frame distortion in dB: (10/ln10) * sqrt(2 |ca_i - cb_j|^2)
    sq = (np.sum(ca * ca, axis=1)[:, None]
          + np.sum(cb * cb, axis=1)[None, :] - 2.0 * (ca @ cb.T))
    dist = (10.0 / _LN10) * np.sqrt(2.0 * np.maximum(sq, 0.0))
    ta, tb = dist.shape
    acc = np.cumsum(dist[0]) + dist[0, 0]    # row 0: left steps only
    for i in range(1, ta):
        d = dist[i]
        diag = np.concatenate(([np.inf], acc[:-1])) + 2.0 * d
        up = acc + d
        m = np.minimum(diag, up)
        s = np.cumsum(d)
        acc = s + np.minimum.accumulate(m - s)
    return float(acc[-1] / (ta + tb))
