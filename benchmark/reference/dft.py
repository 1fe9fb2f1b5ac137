"""Fixed-size Fourier transforms on ``torch.fft``.

Port of ``tpuvc/ops/dft.py``.  The JAX versions are float32 matmuls whose
matrices carry ~1e-4 rad of phase error (float32 theta up to ~3e3 rad);
these go through ``torch.fft`` (pocketfft on the CPU, cuFFT on the card)
and are the more accurate of the two.  ``rdft_ct``, the JAX module's
two-stage matmul DFT that caps float32 accumulation depth on the TPU,
has no counterpart: an FFT already accumulates that way.  The identities
of the JAX module are the contract:

  cos_fwd(x)         == rfft(concat([x, x[-2:0:-1]]), n=fft).real
  cos_inv(c)         == irfft(c, n=fft)[:half]            (c real)
  cos_inv2(a, b)     == irfft(a + i b, n=fft)[:half]
  rdft(x, n, k)      == rfft(x, n=n)[..., :k]  as a (re, im) pair
  irdft(a, b, n)     == irfft(a + i b, n=n)

Frozen plain copy of ``tpuvc_torch/ops/dft.py`` for the benchmark's
reference: no hand kernel, nothing imported from the port.
"""

from __future__ import annotations

import torch


def _even_ext(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x[..., 1:-1].flip(-1)], dim=-1)


def cos_fwd(x: torch.Tensor) -> torch.Tensor:
    """Forward cosine transform of an even half sequence [..., half]."""
    return torch.fft.rfft(_even_ext(x), dim=-1).real.contiguous()


def cos_inv(c: torch.Tensor) -> torch.Tensor:
    """irfft(c)[..., :half] for real coefficients c [..., half]."""
    half = c.shape[-1]
    return torch.fft.irfft(c, n=2 * (half - 1), dim=-1)[..., :half]


def cos_inv2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """irfft(a + i b, fft_size)[..., :half] for real a, b [..., half]."""
    half = a.shape[-1]
    return torch.fft.irfft(torch.complex(a, b), n=2 * (half - 1),
                           dim=-1)[..., :half]


def rdft(x: torch.Tensor, fft_size: int, n_bins: int | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """rfft(x, n=fft_size) as a (re, im) pair, truncated to the first
    ``n_bins`` bins (all fft_size//2 + 1 by default)."""
    spec = torch.fft.rfft(x, n=fft_size, dim=-1)[..., :n_bins]
    return spec.real, spec.imag


def rdft_power(x: torch.Tensor, fft_size: int,
               n_bins: int | None = None) -> torch.Tensor:
    """|rfft(x, fft_size)|^2 over the first ``n_bins`` bins."""
    re, im = rdft(x, fft_size, n_bins)
    return re * re + im * im


def irdft(a: torch.Tensor, b: torch.Tensor, fft_size: int) -> torch.Tensor:
    """irfft(a + i b, n=fft_size), full length."""
    return torch.fft.irfft(torch.complex(a, b), n=fft_size, dim=-1)
