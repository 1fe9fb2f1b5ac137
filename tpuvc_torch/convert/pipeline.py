"""Batched conversion: analysis -> VAE speaker swap -> synthesis.

Port of ``tpuvc/convert/pipeline.py``.  Per utterance of a [B, T] batch:
the WORLD analysis of ``dsp/world.py`` (DIO + StoneMask or Harvest f0,
CheapTrick envelope, D4C aperiodicity; ``DEFAULT_WORLD`` is DIO +
StoneMask with group-delay D4C); the envelope is energy-normalised,
log10'd and mapped to [-1, 1] (Tanhize), encoded, decoded with the target
speaker's code (from z_mu, or a sample of z with ``sample_z``) and
de-normalised; f0 gets the log-linear transform;
minimum-phase synthesis makes the waveform, or, where the converter holds
a vocoder (``models/pwg.py``, Parallel WaveGAN), the vocoder makes it from
the same unit white noise and the converted features' conditioning.
PyTorch runs eagerly, so there is no jit boundary: the batch is written
out as a leading dimension.

The JAX converter draws synthesis noise from ``jax.random`` keyed by each
utterance's seed; here each utterance's noise comes from a
``torch.Generator`` seeded with the same per-utterance seed, so a row's
noise does not depend on the rows beside it.  That makes the
data-parallel mode of ``Converter.convert_batch`` (``mesh=``: each chunk
split over a local device mesh, one model replica per device, one thread
per shard) give every row what the unsharded call gives it.

Stage spans (``utils/profiling.py:span``, recorded only under a
profiler): ``vc.convert_batch`` around a call, ``vc.prep`` per chunk,
``vc.upload``, ``vc.noise`` and ``vc.fetch`` per device call, and inside
the converter ``world.f0`` / ``world.sp`` / ``world.ap``
(``dsp/world.py``), ``vc.model`` (with ``vc.encode`` and ``vc.decode``),
then ``vc.synth`` (WORLD's synthesis) or, with a vocoder, ``vc.vocode``
holding ``vc.vocode.aux`` (the conditioning), ``vc.vocode.upsample`` and
``vc.vocode.stack``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuvc_torch.convert.f0 import convert_f0
from tpuvc_torch.data.normalizer import Tanhize
from tpuvc_torch.dsp.constants import DEFAULT_WORLD, EPSILON, WorldConfig
from tpuvc_torch.dsp.synthesis import synthesis_noise, synthesize
from tpuvc_torch.dsp.world import world_features
from tpuvc_torch.io.wav import resample
from tpuvc_torch.models import pwg
from tpuvc_torch.models.losses import reparameterize
from tpuvc_torch.ops import ulaw
from tpuvc_torch.parallel import mesh as mesh_lib
from tpuvc_torch.utils.device import resolve
from tpuvc_torch.utils.profiling import span

# samples of every utterance converted, and samples of the rows analysed
# for them (the padded length times the rows, a ragged tail's repeated rows
# included): their ratio is the share of the work that was not padding.
# Plain module integers, like the kernels' launch counters: a caller reads
# them and sets them to 0.  Rows that ``MultiStreamConverter`` repeats to
# keep its tick's shape count as real here.
samples_real = 0
samples_analysed = 0


@dataclasses.dataclass(frozen=True)
class ConverterAssets:
    """Everything conversion needs besides the model (host-side)."""

    xmin: np.ndarray          # [513] Tanhize stats
    xmax: np.ndarray
    f0_mu: np.ndarray         # [n_speakers] voiced log-f0 means
    f0_sigma: np.ndarray      # [n_speakers]
    speakers: list[str]


def _normalize_sp(sp, xmin, xmax):
    """energy-normalise + log10 + Tanhize.forward."""
    en = torch.sum(sp + EPSILON, dim=-1, keepdim=True)
    log_sp = torch.log10((sp + EPSILON) / en)
    return Tanhize(xmin, xmax).forward(log_sp), en


def _denormalize_sp(u, en, xmin, xmax):
    # clip to the Tanhize range unconditionally, as the JAX version does:
    # an out-of-range frame would extrapolate log-SP past the corpus max
    log_sp = Tanhize(xmin, xmax).backward(torch.clamp(u, -1.0, 1.0))
    return torch.pow(10.0, log_sp) * en


def make_batch_convert_fn(model, cfg: WorldConfig = DEFAULT_WORLD,
                          sample_z: bool = False, vocoder=None):
    """The batched converter over [B, T] utterances with per-utterance
    target speakers and f0 statistics.

    Returns fn(xs [B, T], y_trgs [B] int, xmin, xmax [513], mu_srcs,
    sd_srcs, mu_trgs, sd_trgs [B], noise [B, (T//hop+1)*hop], eps=None) ->
    waveforms [B, (T//hop+1)*hop].  ``model`` is a
    ``tpuvc_torch.models.vae.VAWGAN`` holding its parameters.  With
    ``sample_z`` the decoder takes z = z_mu + eps * exp(z_lv / 2), ``eps``
    [B, T//hop+1, z_dim] standard normal; otherwise z_mu.  With
    ``vocoder`` (a ``models.pwg.ParallelWaveGAN`` on the model's device)
    the waveform is ``vocoder(noise, aux_features(...))`` of the converted
    features in place of WORLD's synthesis, of the same length."""
    if vocoder is not None and vocoder.spec.hop != cfg.hop:
        raise ValueError(f"the vocoder upsamples by {vocoder.spec.hop} and "
                         f"the analysis hop is {cfg.hop}")

    @torch.no_grad()
    def convert(xs, y_trgs, xmin, xmax, mu_srcs, sd_srcs, mu_trgs, sd_trgs,
                noise, eps=None):
        xs = xs.to(torch.float32)
        bsz = xs.shape[0]
        f0, sp, ap = world_features(xs, cfg)
        n = f0.shape[1]
        with span("vc.model"):
            u, en = _normalize_sp(sp, xmin, xmax)
            with span("vc.encode"):
                z_mu, z_lv = model.encode(u.reshape(bsz * n, -1))
            z = (reparameterize(z_mu, z_lv, eps.reshape(z_mu.shape))
                 if sample_z else z_mu)
            y_vec = y_trgs.to(torch.int64).repeat_interleave(n)
            with span("vc.decode"):
                u_conv = model.decode(z, y_vec).reshape(bsz, n, -1)
            sp_conv = _denormalize_sp(u_conv, en, xmin, xmax)
            f0_conv = convert_f0(f0, mu_srcs, sd_srcs, mu_trgs, sd_trgs)
        if vocoder is not None:
            with span("vc.vocode"):
                with span("vc.vocode.aux"):
                    c = pwg.aux_features(f0_conv, sp_conv, ap, cfg,
                                         vocoder.spec)
                return vocoder(noise, c)
        with span("vc.synth"):
            return synthesize(f0_conv, sp_conv, ap, noise, fs=cfg.fs,
                              hop=cfg.hop, fft_size=cfg.fft_size)

    return convert


def make_convert_fn(model, cfg: WorldConfig = DEFAULT_WORLD,
                    sample_z: bool = False):
    """The single-utterance converter (the JAX ``make_convert_fn``).

    Returns fn(x [T], y_trg, xmin, xmax, mu_src, sd_src, mu_trg, sd_trg,
    seed=0, eps=None, noise=None) -> waveform [(T//hop+1)*hop], on the
    model's device.  The synthesis noise is ``noise`` when given, else
    drawn as ``synthesis_noise([seed])``; with ``sample_z``, ``eps``
    [T//hop+1, z_dim] when given, else standard normal from a
    ``torch.Generator`` seeded with ``seed``."""
    batch = make_batch_convert_fn(model, cfg, sample_z)
    dev = next(model.parameters()).device

    def convert(x, y_trg, xmin, xmax, mu_src, sd_src, mu_trg, sd_trg,
                seed: int = 0, eps=None, noise=None):
        one = lambda v, dt=torch.float32: torch.as_tensor(  # noqa: E731
            v, dtype=dt, device=dev).reshape(1)
        n = x.shape[-1] // cfg.hop + 1
        if noise is None:
            noise = synthesis_noise([seed], n * cfg.hop, dev)[0]
        if sample_z and eps is None:
            g = torch.Generator(device=dev)
            g.manual_seed(int(seed))
            eps = torch.randn((n, model.arch.z_dim), generator=g, device=dev)
        return batch(x.to(dev)[None], one(y_trg, torch.int64), xmin, xmax,
                     one(mu_src), one(sd_src), one(mu_trg), one(sd_trg),
                     noise[None], None if eps is None else eps[None])[0]

    return convert


class Converter:
    """Host-facing conversion API (the JAX ``Converter``)."""

    # one call's audio-seconds budget: batch 128 x 4 s runs as one call
    # on the 80 GB card with either f0 method (peak 13.50 GiB with DIO,
    # 13.68 GiB with Harvest: PERF.md), and with the Parallel WaveGAN
    # vocoder in bf16 (peak 8.93 GiB with DIO since the model's layout
    # copies went: PERF.md)
    MAX_AUDIO_S_PER_CALL = 512.0

    def __init__(self, model, assets: ConverterAssets,
                 cfg: WorldConfig = DEFAULT_WORLD, bucket_s: float = 1.0,
                 transfer_encoding: str = "float32",
                 device: torch.device | str = "cuda", vocoder=None):
        """``transfer_encoding``: "float32", "ulaw8" (1 B/sample) or
        "pcm12" (1.5 B/sample) — the waveform is encoded on the device
        and decoded on the host.  ``device``: the card by default; the
        model must already be on it (``models.params.load_model``).
        ``vocoder``: a ``models.pwg.ParallelWaveGAN`` on the same device
        (``models.pwg.load``) that makes the waveform in place of WORLD's
        synthesis; None for WORLD's."""
        if transfer_encoding not in ("float32", "ulaw8", "pcm12"):
            raise ValueError(f"unknown transfer_encoding "
                             f"{transfer_encoding!r}")
        self.model = model
        self.assets = assets
        self.cfg = cfg
        self.device = resolve(device)
        self.bucket = int(bucket_s * cfg.fs)
        self.transfer_encoding = transfer_encoding
        self.vocoder = vocoder
        self._fn = make_batch_convert_fn(model, cfg, vocoder=vocoder)
        put = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=self.device)
        self._xmin, self._xmax = put(assets.xmin), put(assets.xmax)
        self._replicas: tuple | None = None     # (mesh, per-shard replicas)

    def _replicas_for(self, mesh) -> list:
        """Per shard of ``mesh``: (convert fn, xmin, xmax) on its device,
        the model (and the vocoder) replicated once per distinct device;
        built on the first call with this mesh."""
        if self._replicas is None or self._replicas[0] != mesh:
            models, xmins, xmaxs = (mesh_lib.replicated(mesh, v) for v in (
                self.model, self._xmin, self._xmax))
            vocoders = (mesh_lib.replicated(mesh, self.vocoder)
                        if self.vocoder is not None else [None] * mesh.size)
            self._replicas = (mesh, [
                (make_batch_convert_fn(m, self.cfg, vocoder=v), lo, hi)
                for m, v, lo, hi in zip(models, vocoders, xmins, xmaxs)])
        return self._replicas[1]

    def _encode_transfer(self, y: torch.Tensor) -> torch.Tensor:
        if self.transfer_encoding == "ulaw8":
            return ulaw.ulaw_encode(y)
        if self.transfer_encoding == "pcm12":
            return ulaw.pcm12_encode(y)
        return y

    def _decode_transfer(self, y: np.ndarray, n_samples: int) -> np.ndarray:
        if self.transfer_encoding == "ulaw8":
            return ulaw.ulaw_decode(y)
        if self.transfer_encoding == "pcm12":
            return ulaw.pcm12_decode(y, n_samples)
        return y

    def _coerce_fs(self, x: np.ndarray, fs: int | None) -> np.ndarray:
        if fs is None or fs == self.cfg.fs:
            return np.asarray(x)
        return resample(np.asarray(x), int(fs), self.cfg.fs)

    def _check_speaker_stats(self, *indices: int) -> None:
        for i in indices:
            if not np.isfinite(self.assets.f0_mu[i]):
                raise ValueError(
                    f"speaker {self.assets.speakers[i]!r} has no f0 "
                    "statistics (no training-split utterances were "
                    "analyzed for it)")

    def convert_batch(self, xs: list[np.ndarray], srcs: list[str],
                      trgs: list[str], seed=0, fs: int | None = None,
                      mesh=None) -> list[np.ndarray]:
        """Convert many utterances in batched calls.

        Utterances are padded to the largest common bucket; per-utterance
        source/target speakers may differ.  Requests beyond the per-call
        budget are split into equal chunks padded to one shape.  ``seed``
        is one int (utterance i uses seed + i) or one seed per utterance.

        With ``mesh`` (a local ``tpuvc_torch.parallel.mesh`` data mesh)
        each chunk is split into one shard per device, each converted on
        its device by that device's model replica from a thread of its own,
        and the shards are joined in row order: the budget grows with the
        mesh, and the chunk size is a multiple of its size.
        """
        if not xs:
            return []
        if mesh is not None and mesh.is_process_group:
            raise ValueError("convert_batch serves over a local mesh "
                             "(parallel.mesh.make_mesh): serving across "
                             "processes is not supported")
        outs: list[np.ndarray] = []
        with span("vc.convert_batch"):
            chunks = self._chunks(xs, srcs, trgs, seed, fs, mesh)
            last = False
            while not last:
                # the first chunk's preparation holds the call's own
                with span("vc.prep"):
                    lens, args, seeds, n_samples, last = next(chunks)
                if mesh is None:
                    y = self._convert_rows(self._fn, self.device, self._xmin,
                                           self._xmax, args, seeds,
                                           n_samples)
                else:
                    reps = self._replicas_for(mesh)
                    shards = mesh_lib.shard_batch(mesh, *args)
                    k = len(seeds) // mesh.size

                    def shard(i, d):
                        fn, xmin, xmax = reps[i]
                        return self._convert_rows(
                            fn, d, xmin, xmax, [v[i] for v in shards],
                            seeds[i * k:(i + 1) * k], n_samples)

                    y = np.concatenate(mesh_lib.run_shards(mesh, shard))
                outs.extend(y[i, :n] for i, n in enumerate(lens))
        return outs

    def _chunks(self, xs, srcs, trgs, seed, fs, mesh):
        """``convert_batch``'s preparation: the utterances at the
        converter's rate, the speakers checked, the bucket and the rows per
        chunk chosen on the first ``next``; then per chunk (the lengths of
        its real rows, the rows' arrays, their seeds, the output length,
        whether it is the last), its rows padded and stacked."""
        global samples_real, samples_analysed
        xs = [self._coerce_fs(x, fs) for x in xs]
        a = self.assets
        self._check_speaker_stats(*[a.speakers.index(s) for s in srcs],
                                  *[a.speakers.index(t) for t in trgs])
        lens = [len(x) for x in xs]
        t_pad = max(1, -(-max(lens) // self.bucket)) * self.bucket
        n_samples = (t_pad // self.cfg.hop + 1) * self.cfg.hop
        n_dev = 1 if mesh is None else mesh.size
        # the per-call budget is per device
        max_b = max(1, int(self.MAX_AUDIO_S_PER_CALL * n_dev
                           / (t_pad / self.cfg.fs)))
        n = len(xs)
        n_chunks = -(-n // max_b)
        b = -(-n // n_chunks)
        # a chunk divides over the mesh; rounding down keeps each device
        # within its budget (the tail chunk pads up to b rows)
        b = max(n_dev, (b // n_dev) * n_dev)
        si = np.array([a.speakers.index(s) for s in srcs], np.int64)
        ti = np.array([a.speakers.index(t) for t in trgs], np.int64)
        samples_real += sum(lens)
        for lo in range(0, n, b):
            hi = min(lo + b, n)
            pad_b = b - (hi - lo)          # ragged tail: repeat last row
            rows = [np.pad(np.asarray(x, np.float32), (0, t_pad - len(x)))
                    for x in xs[lo:hi]]
            rows += [rows[-1]] * pad_b
            samples_analysed += b * t_pad
            idx = np.concatenate([np.arange(lo, hi),
                                  np.full(pad_b, hi - 1, np.int64)])
            if np.ndim(seed):
                seeds = np.asarray(seed, np.int64)[idx]
            else:
                seeds = seed + idx
            args = (np.stack(rows), ti[idx], a.f0_mu[si[idx]],
                    a.f0_sigma[si[idx]], a.f0_mu[ti[idx]],
                    a.f0_sigma[ti[idx]])
            yield lens[lo:hi], args, seeds, n_samples, hi == n

    def _convert_rows(self, fn, dev, xmin, xmax, args, seeds,
                      n_samples: int) -> np.ndarray:
        """One call of the batched converter on ``dev`` over the rows
        ``args`` = (waveforms, target ids, source and target f0 means and
        deviations; arrays, or tensors on ``dev``) with the host ``seeds``
        of their noise; the decoded waveforms [rows, n_samples]."""
        xs, ti, mu_s, sd_s, mu_t, sd_t = args
        put = lambda v, dt=torch.float32: torch.as_tensor(  # noqa: E731
            v, dtype=dt, device=dev)
        with span("vc.upload"):
            xs, ti = put(xs), put(ti, torch.int64)
            mu_s, sd_s, mu_t, sd_t = (put(v) for v in (mu_s, sd_s, mu_t,
                                                       sd_t))
        with span("vc.noise"):
            noise = synthesis_noise(seeds, n_samples, dev)
        y = fn(xs, ti, xmin, xmax, mu_s, sd_s, mu_t, sd_t, noise)
        with span("vc.fetch"):
            return self._decode_transfer(
                self._encode_transfer(y).cpu().numpy(), n_samples)

    def convert(self, x: np.ndarray, src: str, trg: str, seed: int = 0,
                fs: int | None = None) -> np.ndarray:
        """Convert one utterance (a batch of one)."""
        return self.convert_batch([x], [src], [trg], seed=[seed], fs=fs)[0]
