"""Plain Parallel WaveGAN: the generator of Yamamoto, Song and Kim
(ICASSP 2020, https://arxiv.org/abs/1910.11480) in float32, and the plain
conversion that vocodes the converted WORLD features with it.

The generator as ``parallel_wavegan.v1`` defines it, written from the
paper's and the published code's equations:

- the conditioning c [B, aux, n] standardized with the mean and the
  standard deviation of the generator's training features (the published
  recipe's ``stats.h5``; the buffers ``aux_mean`` and ``aux_scale``);
- ``ConvInUpsampleNetwork``: c padded by
  ``aux_context_window`` frames on each side by replication, a
  ``Conv1d(aux, aux, 2w + 1)`` without bias, then per upsample scale s a
  nearest-neighbour stretch by s along time (``F.interpolate``) and a
  ``Conv2d(1, 1, (1, 2s + 1))`` without bias over [B, 1, aux, time];
- the stack: a 1x1 convolution of the noise to the residual channels;
  per layer a dilated convolution (dilation 2 ** (layer mod layers per
  stack)) plus a 1x1 projection of the upsampled conditioning, the gated
  unit tanh(a) * sigmoid(b) over the two halves, a 1x1 convolution into
  the skip sum and one back into the residual, (out + x) * sqrt(1/2);
- the skip sum times sqrt(1 / layers), ReLU, 1x1, ReLU, 1x1 to one
  channel.

Departures from the published model, each forced by this pipeline or by
inference:

- upsample scales [4, 5, 4], whose product is the 80-sample hop of
  WORLD's 5 ms frames at 16 kHz (v1's [4, 4, 4, 4] is a 256-sample hop);
- the 80 conditioning channels are made from the converted WORLD
  features (``aux_features``): 77 log mel-band energies of the envelope,
  log(max(M sp, 1e-10)) with M the triangular HTK mel bank (peak 1) over
  v1's band [80, 7600] Hz; log f0 where voiced, else 0; the voicing flag;
  the mean aperiodicity over the bins.  v1 conditions on an 80-band log
  mel of the waveform;
- weight norm folded into plain weights (inference), no dropout.

No kernel and no batching trick: every convolution is a plain
``torch.nn`` module in float32, run with TF32 off inside the call
(``strict_float32``; the settings are restored after it).  The conversion
reuses ``convert.py``'s analysis, model and f0 transform and replaces its
``synthesize`` with the generator on the same per-row noise; nothing is
imported from the port.  ``degrade`` runs the model's and the
generator's operands in fp8 e4m3 and the features through bf16: the
control that the comparison must fail.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import ulaw
from .arch import Architecture
from .convert import (EPSILON, Reference, World, _fp8, _round, _tanhize,
                      _untanhize, convert_f0, world_features)
from .synthesis import synthesis_noise

MEL_FLOOR = 1e-10


class Spec:
    """The generator's settings (a configuration's ``vocoder`` block)."""

    def __init__(self, d: dict):
        self.layers = d["layers"]
        self.stacks = d["stacks"]
        self.residual = d["residual_channels"]
        self.gate = d["gate_channels"]
        self.skip = d["skip_channels"]
        self.aux = d["aux_channels"]
        self.kernel = d["kernel_size"]
        self.window = d["aux_context_window"]
        self.scales = list(d["upsample_scales"])
        self.fmin, self.fmax = d["fmin"], d["fmax"]
        self.n_mels = self.aux - 3


@contextlib.contextmanager
def strict_float32():
    """float32 products in full precision inside the block (no TF32 in
    cuDNN's convolutions or in matmuls); the settings restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class ResidualBlock(nn.Module):
    def __init__(self, spec: Spec, dilation: int):
        super().__init__()
        self.conv = nn.Conv1d(spec.residual, spec.gate, spec.kernel,
                              padding=(spec.kernel - 1) // 2 * dilation,
                              dilation=dilation)
        self.conv1x1_aux = nn.Conv1d(spec.aux, spec.gate, 1, bias=False)
        self.conv1x1_out = nn.Conv1d(spec.gate // 2, spec.residual, 1)
        self.conv1x1_skip = nn.Conv1d(spec.gate // 2, spec.skip, 1)

    def forward(self, x, c):
        xa, xb = self.conv(x).split(self.conv.out_channels // 2, dim=1)
        ca, cb = self.conv1x1_aux(c).split(self.conv.out_channels // 2,
                                           dim=1)
        g = torch.tanh(xa + ca) * torch.sigmoid(xb + cb)
        return (self.conv1x1_out(g) + x) * math.sqrt(0.5), \
            self.conv1x1_skip(g)


class Stretch(nn.Module):
    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, c):
        return F.interpolate(c, scale_factor=(1, self.scale), mode="nearest")


class UpsampleNetwork(nn.Module):
    def __init__(self, scales):
        super().__init__()
        layers = []
        for s in scales:
            layers += [Stretch(s), nn.Conv2d(1, 1, (1, 2 * s + 1),
                                             padding=(0, s), bias=False)]
        self.up_layers = nn.ModuleList(layers)

    def forward(self, c):
        c = c.unsqueeze(1)
        for f in self.up_layers:
            c = f(c)
        return c.squeeze(1)


class ConvInUpsampleNetwork(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        self.conv_in = nn.Conv1d(spec.aux, spec.aux, 2 * spec.window + 1,
                                 bias=False)
        self.upsample = UpsampleNetwork(spec.scales)

    def forward(self, c):
        return self.upsample(self.conv_in(c))


class ParallelWaveGAN(nn.Module):
    """``forward(z [B, T], c [B, aux, n]) -> [B, T]``, T = n x the
    product of the scales."""

    def __init__(self, spec: Spec):
        super().__init__()
        self.spec = spec
        per_stack = spec.layers // spec.stacks
        self.first_conv = nn.Conv1d(1, spec.residual, 1)
        self.conv_layers = nn.ModuleList(
            ResidualBlock(spec, 2 ** (i % per_stack))
            for i in range(spec.layers))
        self.last_conv_layers = nn.ModuleList([
            nn.ReLU(), nn.Conv1d(spec.skip, spec.skip, 1),
            nn.ReLU(), nn.Conv1d(spec.skip, 1, 1)])
        self.upsample_net = ConvInUpsampleNetwork(spec)
        self.register_buffer("aux_mean", torch.zeros(spec.aux))
        self.register_buffer("aux_scale", torch.ones(spec.aux))

    @torch.no_grad()
    def forward(self, z, c):
        w = self.spec.window
        c = (c - self.aux_mean[:, None]) / self.aux_scale[:, None]
        c = F.pad(c, (w, w), mode="replicate")
        c = self.upsample_net(c)
        x = self.first_conv(z[:, None, :])
        skips = 0.0
        for f in self.conv_layers:
            x, h = f(x, c)
            skips = skips + h
        x = skips * math.sqrt(1.0 / len(self.conv_layers))
        for f in self.last_conv_layers:
            x = f(x)
        return x[:, 0]


def make_vocoder(spec: Spec, state: dict, device,
                 fp8: bool = False) -> ParallelWaveGAN:
    """The generator holding ``state`` in float32; with ``fp8`` every
    convolution takes float8 operands (weights and inputs)."""
    model = ParallelWaveGAN(spec)
    model.load_state_dict(state)
    model = model.to(device).eval()
    if fp8:
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                with torch.no_grad():
                    m.weight.copy_(_fp8(m.weight))
                m.register_forward_pre_hook(
                    lambda _m, args: (_fp8(args[0]),))
    return model


def mel_bank(fs: int, fft_size: int, n_mels: int, fmin: float,
             fmax: float) -> np.ndarray:
    """[fft_size/2 + 1, n_mels]: HTK's triangular filters, peak 1, their
    n_mels + 2 edges equally spaced on the mel scale 2595 log10(1 +
    f/700) over [fmin, fmax]."""
    lo_mel = 2595.0 * math.log10(1.0 + fmin / 700.0)
    hi_mel = 2595.0 * math.log10(1.0 + fmax / 700.0)
    bank = np.zeros((fft_size // 2 + 1, n_mels))
    for m in range(n_mels):
        f = [700.0 * (10.0 ** ((lo_mel + (m + j) * (hi_mel - lo_mel)
                                / (n_mels + 1)) / 2595.0) - 1.0)
             for j in range(3)]
        for k in range(fft_size // 2 + 1):
            hz = k * fs / fft_size
            if f[0] < hz <= f[1]:
                bank[k, m] = (hz - f[0]) / (f[1] - f[0])
            elif f[1] < hz < f[2]:
                bank[k, m] = (f[2] - hz) / (f[2] - f[1])
    return bank


def aux_features(f0, sp, ap, cfg: World, spec: Spec) -> torch.Tensor:
    """The generator's conditioning [B, aux, n] from WORLD features f0
    [B, n], sp and ap [B, n, bins]."""
    bank = torch.as_tensor(mel_bank(cfg.fs, cfg.fft_size, spec.n_mels,
                                    spec.fmin, spec.fmax),
                           dtype=torch.float32, device=sp.device)
    mel = torch.log(torch.clamp(torch.matmul(sp, bank), min=MEL_FLOOR))
    voiced = (f0 > 0).to(torch.float32)
    lf0 = torch.log(torch.where(f0 > 0, f0, 1.0)) * voiced
    feats = [mel, lf0[..., None], voiced[..., None],
             torch.mean(ap, dim=-1, keepdim=True)]
    return torch.cat(feats, dim=-1).permute(0, 2, 1)


@torch.no_grad()
def convert_rows(model, vocoder: ParallelWaveGAN, xs, y_trg, xmin, xmax,
                 mu_s, sd_s, mu_t, sd_t, noise, cfg: World,
                 feature_dtype=None) -> torch.Tensor:
    """``convert.convert_rows`` with the generator in place of
    ``synthesize``: [B, T] padded rows -> ([B, (T//hop+1)*hop] waveforms,
    [B, aux, T//hop+1] conditioning that the generator took)."""
    bsz = xs.shape[0]
    f0, sp, ap = (_round(v, feature_dtype)
                  for v in world_features(xs, cfg))
    n = f0.shape[1]
    en = torch.sum(sp + EPSILON, dim=-1, keepdim=True)
    u = _tanhize(torch.log10((sp + EPSILON) / en), xmin, xmax)
    z_mu, _ = model.encode(u.reshape(bsz * n, -1))
    u_conv = model.decode(z_mu, y_trg.repeat_interleave(n)).reshape(
        bsz, n, -1)
    sp_conv = torch.pow(10.0, _untanhize(torch.clamp(u_conv, -1.0, 1.0),
                                         xmin, xmax)) * en
    f0_conv = convert_f0(f0, mu_s, sd_s, mu_t, sd_t)
    with strict_float32():
        c = aux_features(f0_conv, _round(sp_conv, feature_dtype), ap, cfg,
                         vocoder.spec)
        y = vocoder(noise, c)
    return _round(y, feature_dtype), c


class PWGReference(Reference):
    """The plain converter of a configuration with a vocoder: the
    ``Reference`` contract, its waveform from the generator; ``aux`` holds
    the conditioning of the last call's rows."""

    def __init__(self, arch: Architecture, state: dict, assets: dict,
                 world: dict, vocoder: dict, vocoder_state: dict, device,
                 bucket_s: float = 1.0, transfer: str = "float32",
                 degrade: str | None = None):
        """``vocoder``: the configuration's block; ``degrade`` as for
        ``Reference``, "model" and "both" taking the generator's operands
        to fp8 too."""
        super().__init__(arch, state, assets, world, device, bucket_s,
                         transfer, degrade)
        self.vocoder = make_vocoder(Spec(vocoder), vocoder_state,
                                    self.device,
                                    fp8=degrade in ("model", "both"))

    def convert_batch(self, xs, srcs, trgs, seeds) -> list[np.ndarray]:
        a = self.assets
        si = np.array([a["speakers"].index(s) for s in srcs])
        ti = np.array([a["speakers"].index(t) for t in trgs])
        lens = [len(x) for x in xs]
        t_pad = max(1, -(-max(lens) // self.bucket)) * self.bucket
        n_samples = (t_pad // self.cfg.hop + 1) * self.cfg.hop
        rows = np.stack([np.pad(np.asarray(x, np.float32),
                                (0, t_pad - len(x))) for x in xs])
        put = lambda v, dt=torch.float32: torch.as_tensor(  # noqa: E731
            v, dtype=dt, device=self.device)
        mu, sd = np.asarray(a["f0_mu"]), np.asarray(a["f0_sigma"])
        noise = synthesis_noise(np.asarray(seeds), n_samples, self.device)
        y, self.aux = convert_rows(self.model, self.vocoder, put(rows),
                         put(ti, torch.int64), self.xmin, self.xmax,
                         put(mu[si]), put(sd[si]), put(mu[ti]), put(sd[ti]),
                         noise, self.cfg, self.feature_dtype)
        if self.transfer == "ulaw8":
            y = ulaw.ulaw_decode(ulaw.ulaw_encode(y).cpu().numpy())
        elif self.transfer == "float32":
            y = y.cpu().numpy()
        else:
            raise ValueError(f"unknown transfer {self.transfer!r}")
        return [y[i, :n] for i, n in enumerate(lens)]
