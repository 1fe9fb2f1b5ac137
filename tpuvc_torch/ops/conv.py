"""Fused strided Conv1D + LayerNorm + LeakyReLU (the encoder's layers).

Replaces ``tpuvc/ops/pallas_conv.py:conv_ln_lrelu``, which
``models/vae.py:ConvStack`` runs per layer under
``Architecture(conv_impl="pallas")``: a SAME-padded K-tap convolution of
stride s over channels-last [N, L, Cin] frames, plus bias, a LayerNorm
over the Cout channels (epsilon 1e-6) and LeakyReLU, in float32 whatever
the input's type.

CUDA kernel (``csrc/conv.cu``): an implicit-im2col GEMM in which one CTA
owns a tile of output rows and all Cout <= 256 columns, so the norm and the
activation run on its own accumulators and the output is written once.
Where Cin is a multiple of 16 (the encoder's layers 2-5) the products run
on the tensor cores in split TF32 (each float32 operand as a TF32 hi plus
a TF32 lo, three products per pair: float32 accuracy), fed by a ring of
asynchronous copies; the first layer (Cin = 1, Cout = 16, bound by its
bytes) runs one output row per thread, and any other shape on float32 FMA
(see the source).

The plain version is ``F.conv1d`` with Flax SAME padding, then
``F.layer_norm`` and ``F.leaky_relu``, in float32 (the Flax composition
``tests/test_ops.py`` holds the Pallas kernel against).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuvc_torch.ops import _build

LN_EPS = 1e-6          # flax.linen.LayerNorm default
COUTS = (16, 32, 64, 128, 256)  # the encoder's widths, which it is built for


def same_pad(length: int, k: int, s: int) -> tuple[int, int]:
    """Flax ``padding="SAME"`` for a stride-s K-tap convolution: total
    (ceil(L/s) - 1)*s + K - L (at least 0), the low half first."""
    out = -(-length // s)
    total = max((out - 1) * s + k - length, 0)
    return total // 2, total - total // 2


def conv_ln_lrelu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor, stride: int,
                        slope: float) -> torch.Tensor:
    """x [N, L, Cin], w [K, Cin, Cout] -> [N, ceil(L/stride), Cout] float32."""
    f = torch.float32
    xc = x.to(f).transpose(1, 2)
    xc = F.pad(xc, same_pad(xc.shape[-1], w.shape[0], stride))
    y = F.conv1d(xc, w.to(f).permute(2, 1, 0), b.to(f),
                 stride=stride).transpose(1, 2)
    y = F.layer_norm(y, y.shape[-1:], gamma.to(f), beta.to(f), LN_EPS)
    return F.leaky_relu(y, slope)


def conv_ln_lrelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  gamma: torch.Tensor, beta: torch.Tensor, stride: int,
                  slope: float) -> torch.Tensor:
    """Fused SAME-padded strided conv + LayerNorm + LeakyReLU.

    x [N, L, Cin] (any float type; computed in float32), w [K, Cin, Cout]
    (the Flax kernel layout), b/gamma/beta [Cout]; returns
    [N, ceil(L/stride), Cout] float32.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises).
    """
    if x.dim() != 3 or w.dim() != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x must be [N, L, Cin] and w [K, Cin, Cout], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not x.is_floating_point() or stride < 1:
        raise ValueError(f"x must be floating point and stride >= 1, got "
                         f"{x.dtype}, stride {stride}")
    cout = w.shape[2]
    if any(t.shape != (cout,) for t in (b, gamma, beta)):
        raise ValueError("bias, gamma and beta must be [Cout]")
    if x.device.type == "cpu":
        return conv_ln_lrelu_plain(x, w, b, gamma, beta, stride, slope)
    if x.device.type != "cuda":
        raise ValueError("conv kernel needs a CUDA tensor")
    if cout not in COUTS:
        raise ValueError(f"conv kernel is built for Cout in {COUTS}, got "
                         f"{cout}")
    n, length, cin = x.shape
    k = w.shape[0]
    f = torch.float32
    xs = x.to(f).contiguous()
    ws, bs, gs, bts = (t.to(device=x.device, dtype=f).contiguous()
                       for t in (w, b, gamma, beta))
    out = torch.empty((n, -(-length // stride), cout), dtype=f,
                      device=x.device)
    # scratch for the kernel's (hi, lo) TF32 split of the weights
    w_pairs = torch.empty((2 * ws.numel(),), dtype=f, device=x.device)
    _build.launch("tpuvc_conv_ln_lrelu", x.device, xs.data_ptr(),
                  ws.data_ptr(), w_pairs.data_ptr(), bs.data_ptr(),
                  gs.data_ptr(), bts.data_ptr(), out.data_ptr(), n, length,
                  cin, cout, k, stride, float(slope), LN_EPS)
    _build.count("conv")
    return out
