"""Waveform transfer codecs: encode on the device, decode on the host.

Port of ``tpuvc/ops/ulaw.py``.  mu-law 8-bit (G.711 curve, mu = 255,
1 byte/sample) and packed 12-bit PCM (two samples in three bytes).  The
numpy decoders are copied rather than imported: the JAX module imports
``jax.numpy``.

Frozen plain copy of ``tpuvc_torch/ops/ulaw.py`` for the benchmark's
reference: no hand kernel, nothing imported from the port.
"""

from __future__ import annotations

import numpy as np
import torch

_MU = 255.0
_LOG1P_MU = float(np.log1p(_MU))


def ulaw_encode(y: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float audio -> uint8 mu-law code."""
    y = torch.clamp(y, -1.0, 1.0)
    mag = torch.log1p(_MU * torch.abs(y)) * (1.0 / _LOG1P_MU)
    q = torch.round(127.0 * mag)
    return (128.0 + torch.sign(y) * q).to(torch.uint8)


def ulaw_decode(code: np.ndarray) -> np.ndarray:
    """uint8 mu-law code -> float32 audio in [-1, 1] (host-side numpy)."""
    c = np.asarray(code, np.float32) - 128.0
    mag = np.abs(c) / 127.0
    return np.sign(c) * (np.expm1(mag * _LOG1P_MU) / _MU)


def pcm12_encode(y: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float audio [..., T] -> packed 12-bit PCM uint8 [..., T*3/2]
    (odd T is zero-padded; pass the true length to pcm12_decode)."""
    if y.shape[-1] % 2:
        y = torch.nn.functional.pad(y, (0, 1))
    q = torch.round(torch.clamp(y, -1.0, 1.0) * 2047.0).to(torch.int32) + 2048
    a = q[..., 0::2]
    b = q[..., 1::2]
    packed = torch.stack([a >> 4, ((a & 0xF) << 4) | (b >> 8), b & 0xFF],
                         dim=-1)
    return packed.reshape(*packed.shape[:-2], -1).to(torch.uint8)


def pcm12_decode(code: np.ndarray, n_samples: int | None = None
                 ) -> np.ndarray:
    """packed 12-bit PCM uint8 [..., 3k] -> float32 audio [..., 2k]
    (host-side numpy); ``n_samples`` trims the encoder's odd-T pad."""
    c = np.asarray(code, np.int32).reshape(*code.shape[:-1], -1, 3)
    a = (c[..., 0] << 4) | (c[..., 1] >> 4)
    b = ((c[..., 1] & 0xF) << 8) | c[..., 2]
    q = np.stack([a, b], axis=-1).reshape(*c.shape[:-2], -1)
    y = (q.astype(np.float32) - 2048.0) / 2047.0
    return y[..., :n_samples] if n_samples is not None else y
