"""The VAW-GAN's generator and critic, plain PyTorch, the default route.

Frozen plain copy of ``tpuvc_torch/models/vae.py`` without the fused
routes, for the benchmark's reference: activations channels-last
[B, L, C], Flax ``padding="SAME"``, LayerNorm epsilon 1e-6, float32
parameters and ``dtype`` as the compute type (bfloat16 when serving,
float32 when training).  Nothing is imported from the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import losses
from .arch import Architecture, NetSpec

LN_EPS = 1e-6          # flax.linen.LayerNorm default

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def same_pad(length: int, k: int, s: int) -> tuple[int, int]:
    """Flax ``padding="SAME"`` for a stride-s K-tap convolution: total
    (ceil(L/s) - 1)*s + K - L (at least 0), the low half first."""
    out = -(-length // s)
    total = max((out - 1) * s + k - length, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """1-D convolution over [B, L, Cin] with Flax SAME padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        x = h.transpose(1, 2)
        x = F.pad(x, same_pad(x.shape[-1], self.k, self.stride))
        y = F.conv1d(x, self.weight.to(h.dtype), self.bias.to(h.dtype),
                     stride=self.stride)
        return y.transpose(1, 2)


class LayerNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(h, h.shape[-1:], self.weight.to(h.dtype),
                            self.bias.to(h.dtype), LN_EPS)


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return F.linear(h, self.weight.to(h.dtype), self.bias.to(h.dtype))


class ConvStack(nn.Module):
    """Strided convs, each followed by LayerNorm and LeakyReLU."""

    def __init__(self, spec: NetSpec, cin: int, slope: float):
        super().__init__()
        self.slope = slope
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        for k, s, c in zip(spec.kernel, spec.stride, spec.output):
            self.convs.append(Conv(cin, c, k, s))
            self.norms.append(LayerNorm(c))
            cin = c

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            h = F.leaky_relu(norm(conv(h)), self.slope)
        return h


def _stack_len(length: int, spec: NetSpec) -> int:
    for s in spec.stride:
        length = -(-length // s)
    return length


class Encoder(nn.Module):
    """x [B, 513] -> (z_mu, z_log_var) [B, z_dim]."""

    def __init__(self, arch: Architecture):
        super().__init__()
        self.stack = ConvStack(arch.encoder, 1, arch.lrelu_slope)
        flat = _stack_len(arch.x_dim, arch.encoder) * arch.encoder.output[-1]
        self.mu = Dense(flat, arch.z_dim)
        self.log_var = Dense(flat, arch.z_dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        h = self.stack(x[..., None].to(dtype))              # [B, L, C]
        # channels-last flatten
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
        h = F.leaky_relu(self.dense_norm(self.dense(h)), self.slope)
        h = h.reshape(h.shape[0], self.base_len, -1)
        last = len(self.convs) - 1
        for i, (conv, s) in enumerate(zip(self.convs, self.strides)):
            h = conv(h)
            if s > 1:   # depth-to-space, channels-last: [B, L, c*s] -> [B, L*s, c]
                h = h.reshape(h.shape[0], h.shape[1] * s, -1)
            if i < last:
                h = F.leaky_relu(self.norms[i](h), self.slope)
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
    """

    def __init__(self, arch: Architecture):
        super().__init__()
        self.dtype = _DTYPES[arch.compute_dtype]
        self.conditional = arch.d_conditional
        self.stack = ConvStack(arch.discriminator, 1, arch.lrelu_slope)
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
