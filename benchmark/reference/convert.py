"""Plain conversion: what ``Converter.convert_batch`` and the streaming
converters promise, worked out again from the request.

Per utterance of a request: pad to the 1 s bucket of the request's
longest utterance; WORLD analysis with the configuration's f0 method
(DIO + StoneMask, or Harvest), CheapTrick, D4C; energy-normalise, log10
and Tanhize the envelope; encode and decode with the target speaker in
the configuration's compute type; de-normalise; the log-linear f0
transform; minimum-phase synthesis with unit white noise from a
``torch.Generator`` seeded with the row's seed; the transfer codec; trim
to the utterance's length.  The streaming semantics (windows of
[halo | chunk | halo], a seed per window, the equal-power crossfade over
the halo) are ``stream_outputs``.

Frozen plain copies of the port's stages (no hand kernel); nothing is
imported from the port.  ``degrade`` computes the same one precision step
lower: the control that the comparison must fail.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ulaw
from .arch import Architecture
from .cheaptrick import cheaptrick
from .d4c import d4c
from .dio import dio
from .harvest import harvest
from .model import VAWGAN, Conv, Dense
from .stonemask import stonemask
from .synthesis import synthesis_noise, synthesize

EPSILON = 1e-10        # log floor of the envelope


class World:
    """The analysis configuration (the port's ``WorldConfig`` fields)."""

    def __init__(self, fs=16000, frame_period_ms=5.0, f0_floor=71.0,
                 f0_ceil=800.0, fft_size=1024, ap_method="group_delay",
                 f0_method="dio", harvest_channel_decim=1):
        self.fs, self.f0_floor, self.f0_ceil = fs, f0_floor, f0_ceil
        self.fft_size, self.ap_method = fft_size, ap_method
        self.f0_method = f0_method
        self.harvest_channel_decim = harvest_channel_decim
        self.hop = int(fs * frame_period_ms / 1000.0)


@torch.no_grad()
def world_features(x: torch.Tensor, cfg: World):
    x = x.to(torch.float32)
    if cfg.f0_method == "harvest":
        f0 = harvest(x, fs=cfg.fs, hop=cfg.hop, f0_floor=cfg.f0_floor,
                     f0_ceil=cfg.f0_ceil,
                     channel_decim=cfg.harvest_channel_decim)
    elif cfg.f0_method == "dio":
        f0 = stonemask(x, dio(x, fs=cfg.fs, hop=cfg.hop,
                              f0_floor=cfg.f0_floor, f0_ceil=cfg.f0_ceil),
                       hop=cfg.hop, fs=cfg.fs)
    else:
        raise ValueError(f"unknown f0 method {cfg.f0_method!r}")
    sp = cheaptrick(x, f0, hop=cfg.hop, fs=cfg.fs, fft_size=cfg.fft_size)
    ap = d4c(x, f0, hop=cfg.hop, fs=cfg.fs, fft_size=cfg.fft_size,
             method=cfg.ap_method)
    return f0, sp, ap


def _tanhize(x, lo, hi):
    span = torch.clamp(hi - lo, min=1e-6)
    return torch.clamp((x - lo) / span, 0.0, 1.0) * 2.0 - 1.0


def _untanhize(u, lo, hi):
    span = torch.clamp(hi - lo, min=1e-6)
    return (u + 1.0) * 0.5 * span + lo


def convert_f0(f0, mu_src, sigma_src, mu_trg, sigma_trg):
    col = lambda v: v[:, None]  # noqa: E731
    voiced = f0 > 0
    lf = torch.log(torch.where(voiced, f0, 1.0))
    lf2 = ((lf - col(mu_src)) / col(sigma_src) * col(sigma_trg)
           + col(mu_trg))
    return torch.where(voiced, torch.exp(lf2), 0.0)


def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if dtype is None else t.to(dtype).to(torch.float32)


@torch.no_grad()
def convert_rows(model, xs, y_trg, xmin, xmax, mu_s, sd_s, mu_t, sd_t,
                 noise, cfg: World, feature_dtype=None) -> torch.Tensor:
    """[B, T] padded rows -> [B, (T//hop+1)*hop] waveforms.
    ``feature_dtype`` rounds the analysis features and the waveform
    through that type (the control's lower precision)."""
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
    y = synthesize(f0_conv, _round(sp_conv, feature_dtype), ap, noise,
                   fs=cfg.fs, hop=cfg.hop, fft_size=cfg.fft_size)
    return _round(y, feature_dtype)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with a per-tensor scale, back in its
    own type."""
    amax = torch.clamp(t.abs().amax().float(), min=1e-12)
    scale = amax / 448.0
    q = (t.float() / scale).to(torch.float8_e4m3fn)
    return (q.float() * scale).to(t.dtype)


def make_model(arch: Architecture, state: dict, device,
               fp8: bool = False) -> VAWGAN:
    """The reference generator holding ``state``; with ``fp8`` its
    convolutions and dense layers take float8 operands (weights and
    inputs), as an fp8 serving path would."""
    model = VAWGAN(arch)
    model.load_state_dict(state)
    model = model.to(device).eval()
    if fp8:
        for m in model.modules():
            if isinstance(m, (Conv, Dense)):
                with torch.no_grad():
                    m.weight.copy_(_fp8(m.weight))
                m.register_forward_pre_hook(
                    lambda _m, args: (_fp8(args[0]),))
    return model


class Reference:
    """The plain converter of one configuration: ``convert_batch`` has
    the port's ``Converter.convert_batch`` contract over speaker names
    and converts its rows together, as one call of the program does
    (DIO turns a batched FFT's rounding into f0 differences where a row
    is cut or decays into its padding)."""

    def __init__(self, arch: Architecture, state: dict, assets: dict,
                 world: dict, device, bucket_s: float = 1.0,
                 transfer: str = "float32", degrade: str | None = None):
        """``degrade``: "model" (fp8 operands in the model), "features"
        (analysis features and waveform through bf16) or "both" (the
        control: every stage one precision step below the
        configuration's)."""
        if degrade not in (None, "model", "features", "both"):
            raise ValueError(f"unknown degrade {degrade!r}")
        self.cfg = World(**world)
        self.device = torch.device(device)
        self.model = make_model(arch, state, self.device,
                                fp8=degrade in ("model", "both"))
        self.feature_dtype = (torch.bfloat16 if degrade in ("features", "both")
                              else None)
        self.assets = assets
        put = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=self.device)
        self.xmin, self.xmax = put(assets["xmin"]), put(assets["xmax"])
        self.bucket = int(bucket_s * self.cfg.fs)
        self.transfer = transfer

    def convert_batch(self, xs, srcs, trgs, seeds) -> list[np.ndarray]:
        a = self.assets
        si = np.array([a["speakers"].index(s) for s in srcs])
        ti = np.array([a["speakers"].index(t) for t in trgs])
        lens = [len(x) for x in xs]
        t_pad = max(1, -(-max(lens) // self.bucket)) * self.bucket
        hop = self.cfg.hop
        n_samples = (t_pad // hop + 1) * hop
        rows = np.stack([np.pad(np.asarray(x, np.float32),
                                (0, t_pad - len(x))) for x in xs])
        put = lambda v, dt=torch.float32: torch.as_tensor(  # noqa: E731
            v, dtype=dt, device=self.device)
        mu, sd = np.asarray(a["f0_mu"]), np.asarray(a["f0_sigma"])
        noise = synthesis_noise(np.asarray(seeds), n_samples, self.device)
        y = convert_rows(self.model, put(rows), put(ti, torch.int64),
                         self.xmin, self.xmax, put(mu[si]), put(sd[si]),
                         put(mu[ti]), put(sd[ti]), noise, self.cfg,
                         self.feature_dtype)
        if self.transfer == "ulaw8":
            y = ulaw.ulaw_decode(ulaw.ulaw_encode(y).cpu().numpy())
        elif self.transfer == "float32":
            y = y.cpu().numpy()
        else:
            raise ValueError(f"unknown transfer {self.transfer!r}")
        return [y[i, :n] for i, n in enumerate(lens)]


def error_db(got: np.ndarray, ref: np.ndarray, skip_tail: int = 0,
             floor: float = 0.0) -> float:
    """Energy of ``got - ref`` over that of ``ref`` (or ``floor``, where
    larger) in dB, leaving out the last ``skip_tail`` samples (DIO's f0
    is ill-conditioned where an utterance decays into its padding).  A
    floor keeps a near-silent stretch, where a codec step alone is the
    whole signal, from reading as a total error."""
    n = max(1, len(ref) - skip_tail)
    g = np.asarray(got[:n], np.float64)
    r = np.asarray(ref[:n], np.float64)
    if g.shape != r.shape:
        return float("inf")
    if not np.isfinite(g).all():
        return float("inf")
    num = float(np.sum((g - r) ** 2))
    den = max(float(np.sum(r * r)), floor, 1e-30)
    return 10.0 * np.log10(max(num, 1e-30) / den)
