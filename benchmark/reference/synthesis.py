"""WORLD-style synthesis, batched over utterances.

Port of ``tpuvc/dsp/synthesis.py:synthesize``: a per-sample pulse train
(fractional placement by an 8-tap-each-side windowed sinc) and white
noise excite per-frame minimum-phase responses of the periodic
(sp * (1 - ap^2)) and aperiodic (sp * ap^2) parts, and the frames are
overlap-added.

The JAX version draws its noise with ``jax.random.normal``, a stream
torch cannot reproduce, so the noise here is an explicit [B, N*hop]
argument; ``synthesis_noise`` draws it from one seeded
``torch.Generator`` per utterance.
The minimum-phase spectrum goes through ``torch.fft`` (cepstrum, causal
fold, spectrum) where the JAX version folds the same linear map into two
float32 matmuls.

Frozen plain copy of ``tpuvc_torch/dsp/synthesis.py`` for the benchmark's
reference: no hand kernel, nothing imported from the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .constants import DEFAULT_WORLD
from .arith import rdiv
from .dft import irdft, rdft
from .ola import overlap_add


def minimum_phase_log_spectrum(log_amp_half: torch.Tensor, fft_size: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimum-phase log spectrum (re, im) [..., half] from a half-
    spectrum log amplitude: fold the real cepstrum onto the causal side."""
    half = fft_size // 2 + 1
    cep = torch.fft.irfft(log_amp_half, n=fft_size, dim=-1)[..., :half]
    fold = torch.full((half,), 2.0, dtype=cep.dtype, device=cep.device)
    fold[0] = 1.0
    fold[-1] = 1.0
    spec = torch.fft.rfft(cep * fold, n=fft_size, dim=-1)
    return spec.real, spec.imag


def excitation(f0: torch.Tensor, n_samples: int, hop: int, fs: int
               ) -> torch.Tensor:
    """Per-sample pulse train (~unit average power): f0 [B, N] -> [B, S]."""
    bsz = f0.shape[0]
    n_frames = n_samples // hop
    fa = f0[:, :n_frames]
    fb = torch.cat([fa[:, 1:], fa[:, -1:]], dim=-1)
    a = fa[:, :, None].expand(-1, -1, hop).reshape(bsz, -1)
    b = fb[:, :, None].expand(-1, -1, hop).reshape(bsz, -1)
    w = (torch.arange(hop, dtype=torch.float32, device=f0.device) / hop
         ).repeat(n_frames)[None, :]
    both = (a > 0) & (b > 0)
    f0_s = torch.where(both, (1.0 - w) * a + w * b, torch.maximum(a, b))
    vuv = torch.where(w < 0.5, a > 0, b > 0)

    zero = torch.zeros((), device=f0.device)
    phase = 2.0 * math.pi * torch.cumsum(torch.where(vuv, f0_s, zero),
                                         dim=-1) / fs
    cyc = torch.floor(phase / (2.0 * math.pi))
    prev_c = torch.cat([cyc[:, :1] - 1, cyc[:, :-1]], dim=-1)
    is_pulse = (cyc > prev_c) & vuv
    amp = torch.sqrt(rdiv(fs, torch.clamp(f0_s, min=1.0)))
    base = torch.where(is_pulse, amp, zero)
    phi_prev = torch.cat([phase[:, :1] - 2.0 * math.pi, phase[:, :-1]],
                         dim=-1)
    delta = (2.0 * math.pi * cyc - phi_prev) / torch.clamp(
        phase - phi_prev, min=1e-9)
    delta = torch.clamp(delta, 0.0, 1.0)
    pulses = torch.zeros_like(base)
    for k in range(-7, 9):
        u = k + 1.0 - delta                     # tap position vs pulse time
        win = torch.where(torch.abs(u) < 8.0,
                          0.42 + 0.5 * torch.cos(math.pi * u / 8.0)
                          + 0.08 * torch.cos(math.pi * u / 4.0), zero)
        tap = base * torch.sinc(u) * win
        if k < 0:
            pulses[:, :n_samples + k] += tap[:, -k:]
        elif k == 0:
            pulses += tap
        else:
            pulses[:, k:] += tap[:, :n_samples - k]
    return pulses


def synthesize(f0: torch.Tensor, sp: torch.Tensor, ap: torch.Tensor,
               noise: torch.Tensor, fs: int = DEFAULT_WORLD.fs,
               hop: int = DEFAULT_WORLD.hop,
               fft_size: int = DEFAULT_WORLD.fft_size) -> torch.Tensor:
    """Waveform from WORLD features.

    f0 [B, N] Hz (0 = unvoiced); sp [B, N, fft//2+1] power envelope; ap
    [B, N, fft//2+1] aperiodicity ratio; noise [B, N*hop] unit-power white
    noise for the aperiodic source.  Returns [B, N*hop] float32.
    """
    bsz, n_frames = f0.shape
    n_samples = n_frames * hop
    if noise.shape != (bsz, n_samples):
        raise ValueError(f"noise must be [{bsz}, {n_samples}], got "
                         f"{tuple(noise.shape)}")
    f0 = f0.to(torch.float32)
    sp = sp.to(torch.float32)
    ap = ap.to(torch.float32)
    pulses = excitation(f0, n_samples, hop, fs)

    ap2 = torch.clamp(ap * ap, 1e-12, 1.0)
    log_amp_p = 0.5 * torch.log(torch.clamp(sp * (1.0 - ap2), min=1e-20))
    log_amp_n = 0.5 * torch.log(torch.clamp(sp * ap2, min=1e-20))
    la = torch.stack([log_amp_p, log_amp_n], dim=1)       # [B, 2, N, half]
    h_re, h_im = minimum_phase_log_spectrum(la, fft_size)
    mag = torch.exp(h_re)
    hr = mag * torch.cos(h_im)
    hi = mag * torch.sin(h_im)

    seg = torch.stack([pulses.reshape(bsz, n_frames, hop),
                       noise.to(torch.float32).reshape(bsz, n_frames, hop)],
                      dim=1)                              # [B, 2, N, hop]
    er, ei = rdft(seg, fft_size)
    ehr = er * hr - ei * hi
    ehi = er * hi + ei * hr
    resp = irdft(ehr[:, 0] + ehr[:, 1], ehi[:, 0] + ehi[:, 1], fft_size)
    return overlap_add(resp, hop)[:, :n_samples]


def synthesis_noise(seeds, n_samples: int,
                    device: torch.device | str) -> torch.Tensor:
    """Unit white noise [len(seeds), n_samples], one seeded
    ``torch.Generator`` per utterance."""
    rows = []
    for s in np.asarray(seeds).reshape(-1):
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        rows.append(torch.randn(n_samples, generator=g, device=device))
    return torch.stack(rows)
