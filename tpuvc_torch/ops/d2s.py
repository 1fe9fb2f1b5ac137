"""Fused depth-to-space + LayerNorm + LeakyReLU (the decoder's upsampling).

Replaces ``tpuvc/ops/pallas_d2s.py:d2s_ln_lrelu``, which
``models/vae.py:Decoder`` runs after each stride-s subpixel convolution but
the last under ``Architecture(d2s_impl="pallas")``: [N, L, c*s] ->
[N, L*s, c], then a LayerNorm over c (float32 math; gamma and beta first
cast to x's dtype, as the Pallas wrapper does) and LeakyReLU
(h >= 0 ? h : slope*h), in x's dtype.

CUDA kernel (``csrc/d2s.cu``): in a row-major channels-last layout the
depth-to-space is a free view, so the kernel is a LayerNorm over
contiguous rows of c values, c/4 lanes a row, vector loads and stores.
Bound by device-memory bytes.

The plain version is the view, ``F.layer_norm`` in float32 and
``F.leaky_relu``, with the same casts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuvc_torch.ops import _build
from tpuvc_torch.ops.conv import LN_EPS

WIDTHS = (32, 64, 128)   # the decoder's row widths c, which it is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def d2s_ln_lrelu_plain(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, s: int, slope: float,
                       eps: float = LN_EPS) -> torch.Tensor:
    """x [N, L, c*s] -> [N, L*s, c] in x's dtype."""
    n, length, cs = x.shape
    c = cs // s
    f = torch.float32
    h = x.reshape(n, length * s, c).to(f)
    h = F.layer_norm(h, (c,), gamma.to(x.dtype).to(f),
                     beta.to(x.dtype).to(f), eps)
    return F.leaky_relu(h, slope).to(x.dtype)


def d2s_ln_lrelu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 s: int, slope: float, eps: float = LN_EPS) -> torch.Tensor:
    """[N, L, c*s] -> LayerNorm + LeakyReLU of [N, L*s, c], in x's dtype
    (float32 or bfloat16).  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (or raises)."""
    if x.dim() != 3 or s < 1 or x.shape[2] % s:
        raise ValueError(f"x must be [N, L, c*s] with s | c*s, got "
                         f"{tuple(x.shape)}, s={s}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    n, length, cs = x.shape
    c = cs // s
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma and beta must be [{c}]")
    if x.device.type == "cpu":
        return d2s_ln_lrelu_plain(x, gamma, beta, s, slope, eps)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("d2s kernel needs a contiguous CUDA tensor")
    if c not in WIDTHS:
        raise ValueError(f"d2s kernel is built for c in {WIDTHS}, got {c}")
    if x.data_ptr() % 32:
        raise ValueError("d2s kernel needs a 32-byte aligned input")
    # cast as the Pallas wrapper does; fresh copies are aligned
    g, b = (t.to(device=x.device, dtype=x.dtype).clone() for t in (gamma,
                                                                  beta))
    out = torch.empty((n, length * s, c), dtype=x.dtype, device=x.device)
    _build.launch("tpuvc_d2s_ln_lrelu", x.device, x.data_ptr(), g.data_ptr(),
                  b.data_ptr(), out.data_ptr(), n * length * s, c,
                  _DTYPES[x.dtype], float(slope), float(eps))
    _build.count("d2s")
    return out
