"""Parallel WaveGAN's generator, the port's neural vocoder.

Yamamoto, Song and Kim, "Parallel WaveGAN", ICASSP 2020
(https://arxiv.org/abs/1910.11480), at the widths of the published
``parallel_wavegan.v1`` configuration.  For unit white noise z [B, T]
and frame-rate conditioning c [B, aux, n], T = n * hop:

- c standardized with the statistics of the generator's training
  features (``aux_mean``, ``aux_scale``: the published recipe's
  ``stats.h5``, carried in the state dict; a state dict without them
  takes the features as they are);
- upsampling (``ConvInUpsampleNetwork``): c padded by
  ``aux_context_window`` frames on each side by replication, one
  ``Conv1d(aux, aux, 2w + 1, bias=False)``, then per scale s a
  nearest-neighbour stretch by s along time and one time filter of 2s + 1
  taps shared by every channel (the published ``Conv2d(1, 1, (1, 2s + 1))``,
  run here as a ``conv1d`` over the channels as rows);
- the stack: x = Conv1d(1, res, 1)(z); per layer l, dilation
  d = 2 ** (l mod layers/stacks), h = Conv1d(res, gate, k, dilation d)(x)
  + Conv1d(aux, gate, 1, bias=False)(c_up), g = tanh(h_a) * sigmoid(h_b)
  over the two halves of h, skip += Conv1d(gate/2, skip, 1)(g),
  x = (Conv1d(gate/2, res, 1)(g) + x) * sqrt(1/2);
- out: Conv1d(skip, 1, 1)(relu(Conv1d(skip, skip, 1)(relu(skip *
  sqrt(1/layers))))).

Non-causal, no dropout (inference).  The parameters carry the published
module's names, so a trained generator's state dict loads as it is;
weight norm (``weight_g`` / ``weight_v``) is folded into plain weights on
load.  The module's parameters are in its compute type (bf16 on the card);
the waveform comes back in float32.  Each residual layer of a bf16
generator on the card is one launch of K13 (``ops/pwg.py``), which keeps
the layer's gate input and gated unit out of device memory; a float32
generator on the card runs its layers on cuDNN's and cuBLAS's kernels, and
on the CPU each layer is K13's plain version.

In this pipeline the converted features are WORLD's, so the conditioning
is made from them (``aux_features``): ``aux - 3`` log mel-band energies of
the envelope over PWG v1's band [fmin, fmax], log f0 where voiced (else
0), the voicing flag and the mean aperiodicity of a frame.  The upsample
scales multiply to the analysis hop (80 samples at 16 kHz, 5 ms).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuvc_torch.dsp.constants import WorldConfig
from tpuvc_torch.ops import pwg as pwg_op
from tpuvc_torch.utils.device import resolve
from tpuvc_torch.utils.profiling import span

MEL_FLOOR = 1e-10          # log floor of a band's energy
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# keys of the published generator settings that have one supported value
_FIXED = {"model": "ParallelWaveGAN", "in_channels": 1, "out_channels": 1,
          "dropout": 0.0, "upsample_net": "ConvInUpsampleNetwork"}


@dataclasses.dataclass(frozen=True)
class PWGSpec:
    """The generator's widths (published ``generator_params`` names) and
    its feature band; the defaults are ``parallel_wavegan.v1``'s, with
    upsample scales for a hop of 80 samples."""

    layers: int = 30
    stacks: int = 3
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64
    aux_channels: int = 80
    kernel_size: int = 3
    aux_context_window: int = 2
    upsample_scales: tuple[int, ...] = (4, 5, 4)
    fmin: float = 80.0
    fmax: float = 7600.0

    @property
    def hop(self) -> int:
        return math.prod(self.upsample_scales)

    @property
    def n_mels(self) -> int:
        return self.aux_channels - 3

    def dilation(self, layer: int) -> int:
        return 2 ** (layer % (self.layers // self.stacks))

    @classmethod
    def from_json(cls, d: dict) -> "PWGSpec":
        """From a configuration's ``vocoder`` block; the published keys
        that this port supports at one value only must hold it."""
        for k, v in _FIXED.items():
            if k in d and d[k] != v:
                raise ValueError(f"vocoder {k}={d[k]!r}: only {v!r} is "
                                 "supported")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields - set(_FIXED)
        if unknown:
            raise ValueError(f"unknown vocoder keys {sorted(unknown)}")
        kw = {k: v for k, v in d.items() if k in fields}
        if "upsample_scales" in kw:
            kw["upsample_scales"] = tuple(kw["upsample_scales"])
        spec = cls(**kw)
        if spec.layers % spec.stacks or spec.gate_channels % 2:
            raise ValueError("layers must divide into stacks and the gate "
                             "channels into two halves")
        return spec

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["upsample_scales"] = list(self.upsample_scales)
        return d


def _conv_rows(h: torch.Tensor, weight: torch.Tensor, bias=None,
               dilation: int = 1, padding: int = 0,
               groups: int = 1) -> torch.Tensor:
    """A ``Conv1d`` weight [Cout, Cin/groups, K] over channels-last rows h
    [B, L, Cin] -> [B, Lout, Cout] contiguous: one channels-last
    ``conv2d`` over h viewed as [B, Cin, 1, L], with no layout copy on
    either side (as ``models/vae.py`` serves the VAW-GAN)."""
    x = h.unsqueeze(1).permute(0, 3, 1, 2)
    w = weight[:, :, None, :].contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x, w, bias, dilation=(1, dilation), padding=(0, padding),
                 groups=groups)
    return y.permute(0, 2, 3, 1).squeeze(1)


def eager_route(x: torch.Tensor) -> bool:
    """Whether a residual layer on rows like x runs PyTorch's launches
    (``_ResidualBlock.eager``): float32 on the card.  Every other layer
    goes through ``ops/pwg.py:residual_layer``, which launches K13 for
    bf16 on the card and takes its plain version on the CPU."""
    return x.device.type == "cuda" and x.dtype == torch.float32


def _mat(conv: nn.Conv1d) -> torch.Tensor:
    """A 1x1 convolution's weight as the [Cin, Cout] operand of a
    product over rows (a view)."""
    return conv.weight[:, :, 0].t()


class _ResidualBlock(nn.Module):
    def __init__(self, spec: PWGSpec, dilation: int):
        super().__init__()
        half = spec.gate_channels // 2
        self.dilation = dilation
        self.conv = nn.Conv1d(spec.residual_channels, spec.gate_channels,
                              spec.kernel_size, dilation=dilation,
                              padding=(spec.kernel_size - 1) // 2 * dilation)
        self.conv1x1_aux = nn.Conv1d(spec.aux_channels, spec.gate_channels,
                                     1, bias=False)
        self.conv1x1_out = nn.Conv1d(half, spec.residual_channels, 1)
        self.conv1x1_skip = nn.Conv1d(half, spec.skip_channels, 1)
        self._operands = None

    def operands(self) -> pwg_op.Operands:
        """The layer's weights as K13 reads them, laid out once and kept
        (``load_vocoder`` lays them out when it puts the module on its
        device; a move or cast of the module lays them out again)."""
        if self._operands is None:
            self._operands = pwg_op.layer_operands(*(p.detach() for p in (
                self.conv.weight, self.conv.bias, self.conv1x1_aux.weight,
                self.conv1x1_skip.weight, self.conv1x1_out.weight,
                self.conv1x1_out.bias)))
        return self._operands

    def _apply(self, fn, *args, **kwargs):
        # a move or cast gives the parameters new tensors
        self._operands = None
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x, c, skip, out=None):
        """x [B, L, res] and c [B L, aux] rows; adds this layer's skip
        (without its bias) into ``skip`` [B L, skip_channels] and returns
        the next x.  Float32 on the card runs :meth:`eager`; anything else
        is one call of ``ops/pwg.py:residual_layer`` (the next x written
        into ``out`` where given): K13 in bf16 on the card, its plain
        version on the CPU."""
        if eager_route(x):
            return self.eager(x, c, skip)
        return pwg_op.residual_layer(x, c, skip, self.operands(),
                                     self.dilation, out)

    def eager(self, x, c, skip):
        """The layer as PyTorch's launches: cuDNN's dilated convolution,
        then cuBLAS's products adding into their destinations and ATen's
        gate between them."""
        bsz, length, _ = x.shape
        h = _conv_rows(x, self.conv.weight, self.conv.bias, self.dilation,
                       self.conv.padding[0]).view(bsz * length, -1)
        h.addmm_(c, _mat(self.conv1x1_aux))         # + the conditioning
        a, b = h.chunk(2, dim=1)
        g = torch.tanh(a).mul_(torch.sigmoid(b))
        skip.addmm_(g, _mat(self.conv1x1_skip))
        r = math.sqrt(0.5)
        y = torch.addmm(x.view(bsz * length, -1), g, _mat(self.conv1x1_out),
                        beta=r, alpha=r)
        return y.add_(self.conv1x1_out.bias, alpha=r).view(bsz, length, -1)


class _Stretch(nn.Module):
    """Nearest-neighbour stretch along time (the published ``Stretch2d``
    with a frequency scale of 1), of channels-last rows."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, c):
        return c.repeat_interleave(self.scale, dim=1)


class _UpsampleNetwork(nn.Module):
    def __init__(self, scales):
        super().__init__()
        layers = []
        for s in scales:
            layers += [_Stretch(s),
                       nn.Conv2d(1, 1, (1, 2 * s + 1), padding=(0, s),
                                 bias=False)]
        self.up_layers = nn.ModuleList(layers)

    def forward(self, c):
        """Channels-last rows [B, L, aux] -> [B, L x scales, aux]."""
        ch = c.shape[-1]
        for stretch, conv in zip(self.up_layers[::2], self.up_layers[1::2]):
            # the one [1, 1, 1, 2s+1] filter over every channel: depthwise
            w = conv.weight[0].expand(ch, 1, -1)
            c = _conv_rows(stretch(c), w, padding=stretch.scale, groups=ch)
        return c


class _ConvInUpsampleNetwork(nn.Module):
    def __init__(self, spec: PWGSpec):
        super().__init__()
        self.conv_in = nn.Conv1d(spec.aux_channels, spec.aux_channels,
                                 2 * spec.aux_context_window + 1, bias=False)
        self.upsample = _UpsampleNetwork(spec.upsample_scales)

    def forward(self, c):
        return self.upsample(_conv_rows(c, self.conv_in.weight))


class ParallelWaveGAN(nn.Module):
    """The generator: ``forward(z [B, T], c [B, aux, n]) -> [B, T]``
    float32, T = n * hop.  Between layers the activations are
    channels-last rows [B, T, C]; each layer adds its skip into one sum
    (the skip biases are added once).  Where the layers run K13, the stack
    keeps two x buffers and each layer writes the next x into the one its
    input is not in."""

    def __init__(self, spec: PWGSpec = PWGSpec()):
        super().__init__()
        self.spec = spec
        self.first_conv = nn.Conv1d(1, spec.residual_channels, 1)
        self.conv_layers = nn.ModuleList(
            _ResidualBlock(spec, spec.dilation(i))
            for i in range(spec.layers))
        self.last_conv_layers = nn.ModuleList([
            nn.ReLU(), nn.Conv1d(spec.skip_channels, spec.skip_channels, 1),
            nn.ReLU(), nn.Conv1d(spec.skip_channels, 1, 1)])
        self.upsample_net = _ConvInUpsampleNetwork(spec)
        self.register_buffer("aux_mean", torch.zeros(spec.aux_channels))
        self.register_buffer("aux_scale", torch.ones(spec.aux_channels))

    @torch.no_grad()
    def forward(self, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        bsz, n = c.shape[0], c.shape[-1]
        if z.shape[-1] != n * spec.hop:
            raise ValueError(f"{z.shape[-1]} noise samples for {n} frames "
                             f"of {spec.hop}")
        dtype = self.first_conv.weight.dtype
        with span("vc.vocode.upsample"):
            w = spec.aux_context_window
            c = (c.float() - self.aux_mean[:, None]) / self.aux_scale[:, None]
            c = F.pad(c, (w, w), mode="replicate").transpose(1, 2)
            c = self.upsample_net(c.to(dtype).contiguous())
            c = c.view(bsz * z.shape[-1], -1)
        with span("vc.vocode.stack"):
            first, (_, last1, _, last2) = (self.first_conv,
                                           self.last_conv_layers)
            x = torch.addmm(first.bias, z.to(dtype).reshape(-1, 1),
                            _mat(first)).view(bsz, z.shape[-1], -1)
            skip = torch.zeros((c.shape[0], spec.skip_channels), dtype=dtype,
                               device=c.device)
            spare = None if eager_route(x) else torch.empty_like(x)
            bias = 0.0
            for layer in self.conv_layers:
                y = layer(x, c, skip, spare)
                if spare is not None:
                    spare = x
                x = y
                bias = bias + layer.conv1x1_skip.bias.float()
            h = torch.relu_(skip.add_(bias.to(dtype)).mul_(
                math.sqrt(1.0 / len(self.conv_layers))))
            h = torch.relu_(torch.addmm(last1.bias, h, _mat(last1)))
            return torch.addmm(last2.bias, h, _mat(last2)).view(
                bsz, -1).float()


def fold_weight_norm(state: dict) -> dict:
    """A state dict with every weight-normed pair (``<p>.weight_g``,
    ``<p>.weight_v``) replaced by ``<p>.weight`` = g v / |v|, the norm over
    all axes but the first (``torch.nn.utils.weight_norm``'s)."""
    out = {}
    for k, v in state.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            p = k[:-len("_v")]
            g = state[p + "_g"].float()
            v = v.float()
            norm = v.flatten(1).norm(dim=1).view(-1, *([1] * (v.dim() - 1)))
            out[p] = g * v / norm
        else:
            out[k] = v
    return out


def load_vocoder(spec: PWGSpec, state: dict, device="cuda",
                 dtype: str | torch.dtype = torch.float32
                 ) -> ParallelWaveGAN:
    """The generator holding ``state`` (weight norm folded; without
    ``aux_mean`` and ``aux_scale`` the conditioning is taken as it is), on
    ``device`` in the compute type ``dtype``, in eval mode."""
    dtype, device = _DTYPES.get(dtype, dtype), resolve(device)
    model = ParallelWaveGAN(spec)
    full = {"aux_mean": model.aux_mean, "aux_scale": model.aux_scale,
            **fold_weight_norm(state)}
    model.load_state_dict(full)
    model = model.to(device, dtype).eval()
    # the statistics stay in float32 whatever the compute type
    for k in ("aux_mean", "aux_scale"):
        setattr(model, k, full[k].to(device, torch.float32))
    for layer in model.conv_layers:
        layer.operands()
    return model


def vocoder_kernels(vocoder: ParallelWaveGAN) -> tuple:
    """The hand-written kernels (``ops._build.KERNEL_NAMES``) that a call
    of ``vocoder`` launches: K13 (``"pwg"``), once a layer, for a bf16
    generator on the card; none otherwise."""
    w = vocoder.first_conv.weight
    return (("pwg",) if w.device.type == "cuda" and not eager_route(w)
            else ())


def save(path: str, spec: PWGSpec, state: dict) -> None:
    """A vocoder checkpoint: the spec and the state dict
    (``cli.convert --vocoder-checkpoint``)."""
    torch.save({"spec": spec.to_json(),
                "state_dict": {k: v.detach().cpu() for k, v in state.items()}},
               path)


def load(path: str, device="cuda", dtype: str | torch.dtype = torch.float32
         ) -> ParallelWaveGAN:
    """The generator of a checkpoint written by ``save``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return load_vocoder(PWGSpec.from_json(ckpt["spec"]), ckpt["state_dict"],
                        device, dtype)


@functools.lru_cache(maxsize=16)
def mel_bank(fs: int, fft_size: int, n_mels: int, fmin: float, fmax: float,
             device: torch.device) -> torch.Tensor:
    """[fft_size/2 + 1, n_mels] triangular HTK mel filters (peak 1) with
    edges equally spaced in mel over [fmin, fmax], on ``device``."""
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)  # noqa: E731
    edges = 700.0 * (10.0 ** (np.linspace(mel(fmin), mel(fmax), n_mels + 2)
                              / 2595.0) - 1.0)
    freqs = np.arange(fft_size // 2 + 1) * fs / fft_size
    lo, mid, hi = edges[:-2], edges[1:-1], edges[2:]
    up = (freqs[:, None] - lo) / (mid - lo)
    down = (hi - freqs[:, None]) / (hi - mid)
    bank = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return torch.as_tensor(bank, device=device)


def aux_features(f0: torch.Tensor, sp: torch.Tensor, ap: torch.Tensor,
                 cfg: WorldConfig, spec: PWGSpec = PWGSpec()
                 ) -> torch.Tensor:
    """WORLD features f0 [B, n], sp and ap [B, n, fft/2 + 1] ->
    conditioning [B, aux, n] in float32: ``spec.n_mels`` log mel-band
    energies of ``sp``, log f0 where voiced (else 0), the voicing flag, the
    mean aperiodicity."""
    bank = mel_bank(cfg.fs, cfg.fft_size, spec.n_mels, spec.fmin, spec.fmax,
                    sp.device)
    mel = torch.log(torch.clamp(sp.float() @ bank, min=MEL_FLOOR))
    voiced = f0 > 0
    lf0 = torch.where(voiced, torch.log(torch.where(voiced, f0, 1.0)), 0.0)
    return torch.cat([mel, lf0[..., None], voiced.float()[..., None],
                      ap.float().mean(-1, keepdim=True)], -1).transpose(1, 2)
