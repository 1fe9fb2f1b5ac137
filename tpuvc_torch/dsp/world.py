"""WORLD-style analysis and resynthesis entry points.

Port of ``tpuvc/dsp/world.py``: ``analyze`` runs DIO + StoneMask (or
Harvest, which refines by instantaneous frequency itself, so StoneMask is
skipped) -> CheapTrick -> D4C on one utterance, ``analyze_batch`` on a
[B, T] batch of equal-length (padded) utterances, and ``resynthesize``
inverts the features.  They run on the card unless the caller passes
another ``device``; the JAX package's ``vmap`` over utterances is the
batch axis of ``world_features``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuvc_torch.dsp.cheaptrick import cheaptrick
from tpuvc_torch.dsp.constants import DEFAULT_WORLD, WorldConfig
from tpuvc_torch.dsp.d4c import d4c
from tpuvc_torch.dsp.dio import dio
from tpuvc_torch.dsp.harvest import harvest
from tpuvc_torch.dsp.stonemask import stonemask
from tpuvc_torch.dsp.synthesis import synthesis_noise, synthesize
from tpuvc_torch.utils.device import resolve
from tpuvc_torch.utils.profiling import span


class WorldFeatures(NamedTuple):
    f0: torch.Tensor   # [..., N] Hz, 0 = unvoiced
    sp: torch.Tensor   # [..., N, half] power spectral envelope
    ap: torch.Tensor   # [..., N, half] aperiodicity amplitude ratio


@torch.no_grad()
def world_features(x: torch.Tensor,
                   cfg: WorldConfig = DEFAULT_WORLD) -> WorldFeatures:
    """The analysis of x [B, T] on x's device: f0 [B, N], sp and ap
    [B, N, fft_size//2 + 1]."""
    x = x.to(torch.float32)
    with span("world.f0"):
        if cfg.f0_method == "harvest":
            f0 = harvest(x, fs=cfg.fs, hop=cfg.hop, f0_floor=cfg.f0_floor,
                         f0_ceil=cfg.f0_ceil,
                         channel_decim=cfg.harvest_channel_decim)
        elif cfg.f0_method == "dio":
            f0 = stonemask(x, dio(x, fs=cfg.fs, hop=cfg.hop,
                                  f0_floor=cfg.f0_floor,
                                  f0_ceil=cfg.f0_ceil),
                           hop=cfg.hop, fs=cfg.fs)
        else:
            raise ValueError(f"unknown f0 method {cfg.f0_method!r}")
    with span("world.sp"):
        sp = cheaptrick(x, f0, hop=cfg.hop, fs=cfg.fs,
                        fft_size=cfg.fft_size)
    with span("world.ap"):
        ap = d4c(x, f0, hop=cfg.hop, fs=cfg.fs, fft_size=cfg.fft_size,
                 method=cfg.ap_method)
    return WorldFeatures(f0=f0, sp=sp, ap=ap)


def analysis_kernels(cfg: WorldConfig) -> tuple:
    """The hand-written kernels (``ops._build.KERNEL_NAMES``) that
    ``world_features`` launches on the card under ``cfg``: the event
    blocks, their scans and the contour extension of either f0 method,
    CheapTrick's windowing, the envelopes' smoothing, then StoneMask's
    harmonic DFT (DIO) or Harvest's channel merge and refinement, and
    group-delay D4C's top-k sum."""
    f0 = {"dio": ("harmonics",), "harvest": ("merge", "refine")}[
        cfg.f0_method]
    ap = ("topk",) if cfg.ap_method == "group_delay" else ()
    return ("events", "scan", "extend", "window", "smooth") + f0 + ap


def _on(x, device) -> torch.Tensor:
    """An array or tensor as float32 on ``device`` (the card by default)."""
    if not torch.is_tensor(x):
        x = np.asarray(x, np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=resolve(device))


def analyze(x, cfg: WorldConfig = DEFAULT_WORLD,
            device: torch.device | str = "cuda") -> WorldFeatures:
    """Full analysis of one utterance x [T] (array or tensor)."""
    feats = world_features(_on(x, device)[None], cfg)
    return WorldFeatures(*(v[0] for v in feats))


def analyze_batch(xs, cfg: WorldConfig = DEFAULT_WORLD,
                  device: torch.device | str = "cuda") -> WorldFeatures:
    """Analysis of [B, T] equal-length (padded) utterances."""
    return world_features(_on(xs, device), cfg)


@torch.no_grad()
def resynthesize(feats: WorldFeatures, cfg: WorldConfig = DEFAULT_WORLD,
                 seed: int = 0,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
    """Waveform [N * hop] of one utterance's features, on their device.

    The aperiodic source is ``noise`` [N * hop] when given, else unit
    white noise from a ``torch.Generator`` seeded with ``seed``."""
    n_samples = feats.f0.shape[-1] * cfg.hop
    if noise is None:
        noise = synthesis_noise([seed], n_samples, feats.f0.device)[0]
    return synthesize(feats.f0[None], feats.sp[None], feats.ap[None],
                      noise[None], fs=cfg.fs, hop=cfg.hop,
                      fft_size=cfg.fft_size)[0]
