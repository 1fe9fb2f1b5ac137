"""LayerNorm + LeakyReLU over the last axis (K11): the model's
normalisations outside K8 and K9.

Replaces no TPU kernel: the JAX package leaves these LayerNorms to XLA,
which fuses each with its LeakyReLU.  ``models/vae.py:LayerNorm.lrelu``
runs K11 at every encoder layer of the default route, at the decoder's
``dense_norm`` and at each decoder step that K9 does not take, wherever
:func:`engages` (a CUDA tensor, no autograd graph) in a model in eval
mode; on the CPU, in passes that need a backward, and in training it runs
``F.layer_norm`` and ``F.leaky_relu`` as before.  LayerNorm over the last
axis with float32 statistics and epsilon ``LN_EPS``; gamma and beta
rounded to h's dtype first (the model's ``.to(h.dtype)``); LeakyReLU; one
rounding to h's dtype (float32 or bfloat16; the wrapper raises on any
other).

CUDA kernel (``csrc/norm.cu``): many rows a CTA, a row held by C/8 lanes
(bfloat16) or C/4 (float32), at most a warp, with 16-byte vectors,
reduced by shuffles, at the published architecture's widths (16-256 and
the 2432-wide ``dense_norm``, a warp a row); any other width a warp a row
with C read at run time.  The kernel reads contiguous rows: every site of
the model hands it them (the convolutions write channels-last), and any
other h is made contiguous first.  Bound by device-memory bytes (one read
and one write of the activations).

The plain version is ``F.layer_norm`` in float32 and ``F.leaky_relu``,
with the same casts; it matches the model's two calls in h's dtype within
one bfloat16 rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuvc_torch.ops import _build
from tpuvc_torch.ops.conv import LN_EPS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def norm_lrelu_plain(h: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, slope: float,
                     eps: float = LN_EPS) -> torch.Tensor:
    """h [..., C] -> [..., C] contiguous, in h's dtype."""
    f = torch.float32
    y = F.layer_norm(h.to(f), h.shape[-1:], gamma.to(h.dtype).to(f),
                     beta.to(h.dtype).to(f), eps)
    return F.leaky_relu(y, slope).to(h.dtype).contiguous()


def needs_graph(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a graph through a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def engages(h: torch.Tensor, *params: torch.Tensor) -> bool:
    """K11's rule, read from the call's own tensors: h lies on a CUDA
    device and autograd needs no graph through the call (K11 has no
    backward).  Every width and both of the model's compute types have a
    kernel, so the rule asks nothing of them."""
    return h.device.type == "cuda" and not needs_graph(h, *params)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh copy of it (same strides) where it does not start on
    16 bytes."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def norm_lrelu(h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               slope: float, eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm of h [..., C] over C, then LeakyReLU: [..., C] contiguous
    in h's dtype (float32 or bfloat16).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    if h.dim() < 2:
        raise ValueError(f"h must be [..., C], got {tuple(h.shape)}")
    if h.dtype not in _DTYPES:
        raise ValueError(f"h must be float32 or bfloat16, got {h.dtype}")
    c = h.shape[-1]
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma and beta must be [{c}]")
    if h.device.type == "cpu":
        return norm_lrelu_plain(h, gamma, beta, slope, eps)
    if h.device.type != "cuda":
        raise ValueError("norm kernel needs a CUDA tensor")
    x = _aligned(h.contiguous())
    g, b = (_aligned(t.to(device=h.device, dtype=torch.float32).contiguous())
            for t in (gamma, beta))
    out = torch.empty(h.shape, dtype=h.dtype, device=h.device)
    _build.launch("tpuvc_norm_lrelu", h.device, x.data_ptr(), g.data_ptr(),
                  b.data_ptr(), out.data_ptr(), h.numel() // c, c,
                  _DTYPES[h.dtype], float(slope), float(eps))
    _build.count("norm")
    return out
