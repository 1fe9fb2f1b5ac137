"""The speaker-conditioned VAE, its VAW-GAN critic and their forwards.

Port of ``tpuvc/models/vae.py`` (``ConvStack``, ``Encoder``, ``Decoder``,
``Critic``, ``CVAE``, ``VAWGAN``, ``make_model``).  Activations stay
channels-last [B, L, C] between layers, as in the Flax model, so the
encoder's flatten and the decoder's depth-to-space are the same reshapes.
Flax conventions kept: ``padding="SAME"`` (total (out-1)*s + k - L, low
half first), LayerNorm epsilon 1e-6.  Parameters are float32; ``dtype``
(bfloat16 on the card) is the compute type.

Each convolution reads and writes the activations where they lie: where
no autograd graph runs through it and the module is not in train mode
(serving, on any device), it is one ``F.conv2d`` over h [B, L, Cin] viewed
as a channels-last [B, Cin, 1, L], SAME padding passed to the call where
it is symmetric (one copy of h padded along L where it is not), its
channels-last output viewed back as a contiguous [B, Lout, Cout]: no
layout copy on either side, and the depth-to-space reshape after it a
view.  Everywhere else (training's passes, the critic's updates) it
transposes to [B, C, L] around ``F.conv1d``: training's card-against-CPU
rule (``chip_smoke.py`` phase 6) sits inside float32 conditioning and
fails on the channels-last route.

``VAWGAN`` (and ``CVAE``) hold the encoder and decoder only, the generator
half the converter serves; the ``Critic`` is a module of its own with its
own state dict.  A trainer holds both, each with its own optimizer: the
Flax model's ``split_gan_params`` made structural.

The architecture's two kernel switches pick routes, not parameters (the
state dict is the same for both):
- ``conv_impl="pallas"``: each encoder layer is one fused conv + LayerNorm
  + LeakyReLU (``ops/conv.py``), in float32 whatever the compute type, as
  the JAX branch; the dense heads then cast back to the compute type.
- ``d2s_impl="pallas"``: after each stride-s decoder conv but the last,
  depth-to-space + LayerNorm + LeakyReLU run fused (``ops/d2s.py``).

Every other LayerNorm + LeakyReLU pair is ``LayerNorm.lrelu``: one launch
of K11 (``ops/norm.py``) wherever the activations lie on the card and no
gradient needs the graph, at any width, else ``F.layer_norm`` and
``F.leaky_relu``: on the CPU and in passes that need a backward.  One
exception is training's: a module in train mode keeps the two calls in its
no-grad passes too (the critic updates' generator forward), so that they
round as its backward-capable ones do.  ``load_model`` gives a model in
eval mode for serving.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuvc_torch.models import losses
from tpuvc_torch.ops import norm as norm_op
from tpuvc_torch.ops.conv import LN_EPS, conv_ln_lrelu, same_pad
from tpuvc_torch.ops.d2s import d2s_ln_lrelu
from tpuvc_torch.utils.config import Architecture, NetSpec

IMPLS = ("xla", "pallas")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_impls(arch: Architecture) -> None:
    for field in ("conv_impl", "d2s_impl"):
        if getattr(arch, field) not in IMPLS:
            raise ValueError(f"unknown {field} {getattr(arch, field)!r}; "
                             f"expected one of {IMPLS}")


def serving_kernels(arch: Architecture) -> tuple:
    """The hand-written kernels (``ops._build.KERNEL_NAMES``) that a
    serving call of ``arch``'s model launches on the card: K11 on every
    route, K8 and K9 where their switches pick them."""
    return (("norm",) + (("conv",) if arch.conv_impl == "pallas" else ())
            + (("d2s",) if arch.d2s_impl == "pallas" else ()))


class Conv(nn.Module):
    """1-D convolution over [B, L, Cin] with Flax SAME padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if not self.training and not norm_op.needs_graph(h, self.weight,
                                                         self.bias):
            return self._nhwc(h)
        x = h.transpose(1, 2)
        x = F.pad(x, same_pad(x.shape[-1], self.k, self.stride))
        y = F.conv1d(x, self.weight.to(h.dtype), self.bias.to(h.dtype),
                     stride=self.stride)
        return y.transpose(1, 2)

    def _nhwc(self, h: torch.Tensor) -> torch.Tensor:
        """The serving route: h [B, L, Cin] -> [B, Lout, Cout] contiguous
        (for a contiguous h), one channels-last convolution."""
        lo, hi = same_pad(h.shape[1], self.k, self.stride)
        if lo != hi:
            h, lo = F.pad(h, (0, 0, lo, hi)), 0
        x = h.unsqueeze(1).permute(0, 3, 1, 2)        # [B, Cin, 1, L], NHWC
        w = self.weight[:, :, None, :].to(h.dtype,
                                          memory_format=torch.channels_last)
        y = F.conv2d(x, w, self.bias.to(h.dtype), stride=(1, self.stride),
                     padding=(0, lo))
        return y.permute(0, 2, 3, 1).squeeze(1)


class LayerNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(h, h.shape[-1:], self.weight.to(h.dtype),
                            self.bias.to(h.dtype), LN_EPS)

    def lrelu(self, h: torch.Tensor, slope: float) -> torch.Tensor:
        """LeakyReLU of the norm of h, contiguous: K11 where
        ``norm_op.engages``, else the two PyTorch calls (on the CPU and in
        passes whose gradient needs the graph); in train mode, the
        training exception, always the two calls."""
        if not self.training and norm_op.engages(h, self.weight, self.bias):
            return norm_op.norm_lrelu(h, self.weight, self.bias, slope)
        return F.leaky_relu(self(h), slope)


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return F.linear(h, self.weight.to(h.dtype), self.bias.to(h.dtype))


class ConvStack(nn.Module):
    """Strided convs, each followed by LayerNorm and LeakyReLU; ``fused``
    runs each layer as the fused kernel, in float32."""

    def __init__(self, spec: NetSpec, cin: int, slope: float,
                 fused: bool = False):
        super().__init__()
        self.slope = slope
        self.fused = fused
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        for k, s, c in zip(spec.kernel, spec.stride, spec.output):
            self.convs.append(Conv(cin, c, k, s))
            self.norms.append(LayerNorm(c))
            cin = c

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            if self.fused:
                h = conv_ln_lrelu(h, conv.weight.permute(2, 1, 0), conv.bias,
                                  norm.weight, norm.bias, conv.stride,
                                  self.slope)
            else:
                h = norm.lrelu(conv(h), self.slope)
        return h


def _stack_len(length: int, spec: NetSpec) -> int:
    for s in spec.stride:
        length = -(-length // s)
    return length


class Encoder(nn.Module):
    """x [B, 513] -> (z_mu, z_log_var) [B, z_dim]."""

    def __init__(self, arch: Architecture):
        super().__init__()
        self.stack = ConvStack(arch.encoder, 1, arch.lrelu_slope,
                               fused=arch.conv_impl == "pallas")
        flat = _stack_len(arch.x_dim, arch.encoder) * arch.encoder.output[-1]
        self.mu = Dense(flat, arch.z_dim)
        self.log_var = Dense(flat, arch.z_dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        h = self.stack(x[..., None].to(dtype))              # [B, L, C]
        # channels-last flatten; the fused stack's float32 output goes back
        # to the compute type, as nn.Dense(dtype=...) casts its input
        h = h.reshape(h.shape[0], -1).to(dtype)
        return self.mu(h).float(), self.log_var(h).float()


class Decoder(nn.Module):
    """(z [B, z_dim], y [B] int) -> x_hat [B, 513]: speaker embedding
    concatenated with z, a dense layer to 19 positions, then subpixel
    (conv + depth-to-space) upsampling 19 -> 57 -> 171 -> 513."""

    base_len = 19

    def __init__(self, arch: Architecture):
        super().__init__()
        spec = arch.generator
        self.slope = arch.lrelu_slope
        self.tanh = arch.output_activation == "tanh"
        self.fused_d2s = arch.d2s_impl == "pallas"
        self.embed = nn.Parameter(torch.empty(arch.y_dim, arch.y_emb_dim))
        c0 = spec.output[0]
        self.dense = Dense(arch.z_dim + arch.y_emb_dim, self.base_len * c0)
        self.dense_norm = LayerNorm(self.base_len * c0)
        self.strides = tuple(spec.stride)
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        cin = c0
        for i, (k, s, c) in enumerate(zip(spec.kernel, spec.stride,
                                          spec.output)):
            self.convs.append(Conv(cin, c * s, k, 1))
            if i < len(spec.kernel) - 1:
                self.norms.append(LayerNorm(c))
            cin = c
        if spec.output[-1] != 1:
            raise ValueError("decoder's last layer must have 1 channel")

    def forward(self, z: torch.Tensor, y: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        emb = self.embed.to(dtype)[y]
        h = torch.cat([z.to(dtype), emb], dim=-1)
        h = self.dense_norm.lrelu(self.dense(h), self.slope)
        h = h.reshape(h.shape[0], self.base_len, -1)
        last = len(self.convs) - 1
        for i, (conv, s) in enumerate(zip(self.convs, self.strides)):
            h = conv(h)
            if s > 1 and i < last and self.fused_d2s:
                norm = self.norms[i]
                h = d2s_ln_lrelu(h.contiguous(), norm.weight, norm.bias, s,
                                 self.slope)
                continue
            if s > 1:   # depth-to-space, channels-last: [B, L, c*s] -> [B, L*s, c]
                h = h.reshape(h.shape[0], h.shape[1] * s, -1)
            if i < last:
                h = self.norms[i].lrelu(h, self.slope)
        out = h.squeeze(-1)
        if self.tanh:
            out = torch.tanh(out)
        return out.float()


class Critic(nn.Module):
    """Wasserstein critic x [B, 513] (and y [B]) -> score [B], float32.

    A conv stack over ``arch.discriminator``, then a dense score.  With
    ``arch.d_conditional`` (the default) the speaker enters as the
    projection term <project(h), embed(y)> (a cGAN projection critic);
    without y the score is the unconditioned one, as in the Flax model.
    ``conv_impl="pallas"`` runs the stack's layers fused, as the encoder's.
    """

    def __init__(self, arch: Architecture):
        super().__init__()
        _check_impls(arch)
        self.dtype = _DTYPES[arch.compute_dtype]
        self.conditional = arch.d_conditional
        self.stack = ConvStack(arch.discriminator, 1, arch.lrelu_slope,
                               fused=arch.conv_impl == "pallas")
        flat = (_stack_len(arch.x_dim, arch.discriminator)
                * arch.discriminator.output[-1])
        self.score = Dense(flat, 1)
        if self.conditional:
            self.project = Dense(flat, arch.y_emb_dim)
            self.embed = nn.Parameter(torch.empty(arch.y_dim,
                                                  arch.y_emb_dim))

    def forward(self, x: torch.Tensor,
                y: torch.Tensor | None = None) -> torch.Tensor:
        h = self.stack(x[..., None].to(self.dtype))
        h = h.reshape(h.shape[0], -1).to(self.dtype)
        score = self.score(h)[..., 0]
        if self.conditional and y is not None:
            emb = self.embed.to(self.dtype)[y]
            score = score + torch.sum(self.project(h) * emb, dim=-1)
        return score.float()


class CVAE(nn.Module):
    """The speaker-conditioned VAE (the reference model "VAE"): ``encode``,
    ``decode``, the training forward and its loss."""

    def __init__(self, arch: Architecture):
        super().__init__()
        _check_impls(arch)
        self.arch = arch
        self.dtype = _DTYPES[arch.compute_dtype]
        self.encoder = Encoder(arch)
        self.decoder = Decoder(arch)

    def encode(self, x: torch.Tensor):
        return self.encoder(x, self.dtype)

    def decode(self, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.decoder(z, y, self.dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                eps: torch.Tensor) -> dict[str, torch.Tensor]:
        """Encode, sample z = mu + eps e^(lv/2) with the given noise
        ``eps`` [B, z_dim], decode: ``z_mu, z_lv, z, xh``."""
        mu, lv = self.encode(x)
        z = losses.reparameterize(mu, lv, eps)
        return {"z_mu": mu, "z_lv": lv, "z": z, "xh": self.decode(z, y)}

    def loss(self, x: torch.Tensor, y: torch.Tensor, eps: torch.Tensor):
        """The reference's ``model.loss()``: ({D_KL, logP, loss}, forward
        outputs)."""
        out = self(x, y, eps)
        kld = losses.gaussian_kld(out["z_mu"], out["z_lv"])
        logp = losses.gaussian_log_density(x, out["xh"])
        return {"D_KL": kld, "logP": logp, "loss": kld - logp}, out


class VAWGAN(CVAE):
    """The VAW-GAN's generator (encoder + decoder; the reference model
    "VAWGAN").  Its ``Critic`` is a module of its own."""


def make_model(arch: Architecture) -> CVAE:
    """The generator module of ``arch.model`` ("VAE" or "VAWGAN")."""
    registry = {"VAE": CVAE, "VAWGAN": VAWGAN}
    try:
        cls = registry[arch.model]
    except KeyError as e:
        raise KeyError(f"unknown model {arch.model!r}; "
                       f"known: {sorted(registry)}") from e
    if arch.output_activation not in ("tanh", "linear"):
        raise ValueError(f"unknown output_activation "
                         f"{arch.output_activation!r}; "
                         "expected 'tanh' | 'linear'")
    return cls(arch)
