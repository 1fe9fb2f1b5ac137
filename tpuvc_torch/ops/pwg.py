"""One residual layer of Parallel WaveGAN's generator (K13): the dilated
convolution, the conditioning's projection, the gated unit and both 1x1
convolutions of a layer in one pass.

For x [B, T, res] channels-last rows, the upsampled conditioning c [B T,
aux] and the running skip sum [B T, skip], with W1 the dilated
convolution's taps over the residual channels stacked on
``conv1x1_aux``'s weight, and W2 = [W_skip | W_out]:

    h     = [x(t - d) | ... | x(t + d) | c(t)] . W1 + b_conv
    g     = tanh(h[:gate/2]) * sigmoid(h[gate/2:])
    [s|o] = g . W2
    skip += s                       (in place; the skip biases are summed
                                     once after the stack)
    x'    = sqrt(1/2) * (x + o + b_out)

with SAME padding (taps outside [0, T) read zero).  Every sum is float32;
g, the skip sum and x' are rounded to x's dtype, once each.

CUDA kernel (``csrc/pwg.cu``); it replaces no Pallas kernel (the JAX
package has no vocoder).  It was added because the layer, as PyTorch
launches, took about ten kernels that each wrote h [B T, gate] or g [B T,
gate/2] to device memory for the next to read back: ~330 ms of a 64 x 6 s
corpus call's 30 layers went to that glue and those products.  Bound:
device-memory bytes, the 672 B a position that the layer must move (x, c
and skip read, skip and x' written), at 128 operations a byte.  The
design keeps h and g out of device memory: a pair of warps takes 32
positions, each warp 32 of h's gate-a columns and the 32 gate-b columns
that pair with them, on the tensor cores (mma.sync, bf16 operands,
float32 accumulators), so the thread holding h[j] holds h[64 + j] too and
gates it in registers; g, rounded once, goes to shared memory for the
pair's second product, and skip and x' leave in 16-byte stores.  The
weights sit in shared memory for the whole launch, and each pair's next
tile of x and c is in flight while it computes.  K13 takes the published
``parallel_wavegan.v1`` widths (res 64, gate 128, skip 64, aux 80, kernel
3) in bfloat16.

The plain version repeats the kernel's arithmetic in float32 with the
kernel's three roundings (its tanh and sigmoid are PyTorch's, within a
quarter of a bf16 step of the kernel's): at any widths and kernel size,
and in float32 it is the float32 layer.  :func:`residual_layer` takes it
for CPU tensors, launches K13 for bfloat16 on the card and raises for any
other CUDA dtype or width.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpuvc_torch.ops import _build

RES, GATE, SKIP, AUX, TAPS = 64, 128, 64, 80, 3     # K13's widths
SCALE = math.sqrt(0.5)                              # the residual's scale


class Operands(NamedTuple):
    """A layer's weights as K13 reads them (rows are output channels)."""

    w1: torch.Tensor        # [gate, taps res + aux], the layer's dtype
    w2: torch.Tensor        # [skip + res, gate/2]
    b_conv: torch.Tensor    # [gate] float32
    b_out: torch.Tensor     # [res] float32


def layer_operands(conv_w, conv_b, aux_w, skip_w, out_w,
                   out_b) -> Operands:
    """From the ``Conv1d`` weights of a layer: the dilated convolution's
    [gate, res, k] and bias, ``conv1x1_aux``'s [gate, aux, 1], the skip
    and out 1x1s' [skip, gate/2, 1] and [res, gate/2, 1] and the out bias.
    W1's column tap * res + channel multiplies x(t + (tap - (k-1)/2) d)."""
    gate, res, k = conv_w.shape
    w1 = torch.cat([conv_w.permute(0, 2, 1).reshape(gate, k * res),
                    aux_w[:, :, 0]], dim=1)
    w2 = torch.cat([skip_w[:, :, 0], out_w[:, :, 0]], dim=0)
    return Operands(w1.contiguous(), w2.contiguous(),
                    conv_b.float().contiguous(), out_b.float().contiguous())


def residual_layer_plain(x: torch.Tensor, c: torch.Tensor,
                         skip: torch.Tensor, ops: Operands, dilation: int,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`residual_layer` (same contract, any
    widths and kernel size)."""
    bsz, t, res = x.shape
    f = torch.float32
    k = (ops.w1.shape[1] - c.shape[-1]) // res
    pad = (k - 1) // 2 * dilation
    xf = x.to(f)
    xp = F.pad(xf, (0, 0, pad, pad))
    a1 = torch.cat([xp[:, i * dilation:i * dilation + t] for i in range(k)]
                   + [c.reshape(bsz, t, -1).to(f)], dim=-1)
    h = torch.addmm(ops.b_conv, a1.reshape(bsz * t, -1), ops.w1.to(f).t())
    ha, hb = h.chunk(2, dim=1)
    g = (torch.tanh(ha) * torch.sigmoid(hb)).to(x.dtype).to(f)
    s, o = (g @ ops.w2.to(f).t()).split([skip.shape[-1], res], dim=1)
    skip.copy_(skip.to(f) + s)
    y = ((xf.reshape(bsz * t, res) + o + ops.b_out) * SCALE).to(x.dtype)
    y = y.view(bsz, t, res)
    return y if out is None else out.copy_(y)


def residual_layer(x: torch.Tensor, c: torch.Tensor, skip: torch.Tensor,
                   ops: Operands, dilation: int,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, T, res], c [B T, aux] (or [B, T, aux]) and skip [B T, skip],
    all in one dtype, contiguous; ``ops`` from :func:`layer_operands` in
    that dtype; dilation >= 1 -> the next x [B, T, res], written into
    ``out`` where given (which must not overlap x: neighbouring positions
    read x(t +- d)).  Adds the layer's skip (without its bias) into
    ``skip`` in place.

    A CPU tensor takes the plain version; a CUDA tensor launches K13 (or
    raises).
    """
    if x.dim() != 3:
        raise ValueError(f"residual_layer needs x [B, T, res], got "
                         f"{tuple(x.shape)}")
    bsz, t, res = x.shape
    if (c.shape[-1] * bsz * t != c.numel()
            or tuple(skip.shape) != (bsz * t, skip.shape[-1])
            or ops.w1.shape[1] <= c.shape[-1]
            or ops.w2.shape[0] != skip.shape[-1] + res):
        raise ValueError(f"residual_layer: x {tuple(x.shape)}, c "
                         f"{tuple(c.shape)}, skip {tuple(skip.shape)} and "
                         f"W1 {tuple(ops.w1.shape)}, W2 "
                         f"{tuple(ops.w2.shape)} do not fit together")
    if not (x.dtype == c.dtype == skip.dtype == ops.w1.dtype
            == ops.w2.dtype):
        raise ValueError(f"residual_layer needs one dtype: x {x.dtype}, c "
                         f"{c.dtype}, skip {skip.dtype}, W1 {ops.w1.dtype}, "
                         f"W2 {ops.w2.dtype}")
    if dilation < 1:
        raise ValueError(f"residual_layer: dilation {dilation}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError(f"residual_layer: out {tuple(out.shape)} "
                         f"{out.dtype} on {out.device} for x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if x.device.type == "cpu":
        return residual_layer_plain(x, c, skip, ops, dilation, out)
    if x.device.type != "cuda":
        raise ValueError(f"residual_layer: no kernel on {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"residual_layer: K13 takes bfloat16, got "
                         f"{x.dtype}")
    if (tuple(ops.w1.shape) != (GATE, TAPS * RES + AUX)
            or tuple(ops.w2.shape) != (SKIP + RES, GATE // 2)
            or c.shape[-1] != AUX):
        raise ValueError(f"residual_layer: K13 takes the widths res {RES}, "
                         f"gate {GATE}, skip {SKIP}, aux {AUX}, kernel "
                         f"{TAPS}; got W1 {tuple(ops.w1.shape)}, W2 "
                         f"{tuple(ops.w2.shape)}, c {tuple(c.shape)}")
    tensors = (x, c, skip, *ops)
    if any(v.device != x.device for v in tensors):
        raise ValueError("residual_layer: the tensors lie on "
                         f"{sorted({str(v.device) for v in tensors})}")
    if out is None:
        out = torch.empty_like(x)
    if not all(v.is_contiguous() and v.data_ptr() % 16 == 0
               for v in (*tensors, out)):
        raise ValueError("residual_layer needs contiguous tensors that "
                         "start on 16 bytes")
    if (out.data_ptr() < x.data_ptr() + x.nbytes
            and x.data_ptr() < out.data_ptr() + out.nbytes):
        raise ValueError("residual_layer: out overlaps x")
    _build.launch("tpuvc_pwg_residual", x.device, x.data_ptr(), c.data_ptr(),
                  skip.data_ptr(), out.data_ptr(), ops.w1.data_ptr(),
                  ops.w2.data_ptr(), ops.b_conv.data_ptr(),
                  ops.b_out.data_ptr(), bsz, t, dilation, SCALE)
    _build.count("pwg")
    return out
