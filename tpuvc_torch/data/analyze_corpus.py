"""Corpus analysis: wav tree -> .bin records + stats.

Port of ``tpuvc/data/analyze_corpus.py`` (the reference analyzer's batch
extractor): walks the corpus, pads each utterance to a length bucket and
runs ``tpuvc_torch.dsp.world.analyze`` on the card (or the device the
caller names), writes reference-layout .bin records, and produces the
etc/ stats (Tanhize min/max over the training split, per-speaker voiced
log-f0 mean/std).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpuvc_torch.convert.f0 import f0_statistics
from tpuvc_torch.dsp.constants import DEFAULT_WORLD, WorldConfig
from tpuvc_torch.dsp.world import analyze
from tpuvc_torch.io import corpus as corpus_io
from tpuvc_torch.io.records import Features, energy_normalize_sp, write_bin
from tpuvc_torch.io.wav import read_wav


def analyze_utterance(x: np.ndarray, cfg: WorldConfig,
                      bucket_s: float = 1.0,
                      device: torch.device | str = "cuda"):
    """Pad to a length bucket, analyze on ``device``, trim to the true
    frames; (f0, sp, ap) as numpy."""
    bucket = max(1, int(bucket_s * cfg.fs))
    n_pad = max(1, -(-len(x) // bucket)) * bucket
    n_frames = cfg.num_frames(len(x))
    feats = analyze(np.pad(np.asarray(x, np.float32), (0, n_pad - len(x))),
                    cfg, device=device)
    return tuple(v[:n_frames].cpu().numpy() for v in feats)


def analyze_corpus(corpus_root: str, cfg: WorldConfig = DEFAULT_WORLD,
                   splits: tuple[str, ...] = (corpus_io.TRAIN_SPLIT,
                                              corpus_io.TEST_SPLIT),
                   bucket_s: float = 1.0, verbose: bool = False,
                   device: torch.device | str = "cuda") -> None:
    etc = os.path.join(corpus_root, "etc")
    try:
        speakers = corpus_io.read_speakers(etc)
    except FileNotFoundError:
        wav_train = os.path.join(corpus_root, "wav", corpus_io.TRAIN_SPLIT)
        speakers = sorted(os.listdir(wav_train))
        corpus_io.write_speakers(etc, speakers)

    xmin = None
    xmax = None
    f0_by_speaker: dict[int, list[np.ndarray]] = {}

    for split in splits:
        for spk in speakers:
            label = corpus_io.speaker_index(speakers, spk)
            for wav_path in corpus_io.list_wavs(corpus_root, split, spk):
                # resampled to the pipeline rate on read, as the
                # reference's librosa.load(sr=16000)
                x, _ = read_wav(wav_path, target_fs=cfg.fs)
                f0, sp, ap = analyze_utterance(x, cfg, bucket_s, device)
                log_sp, en = energy_normalize_sp(sp)
                write_bin(corpus_io.bin_path_for_wav(corpus_root, wav_path),
                          Features(sp=log_sp.astype(np.float32),
                                   ap=ap.astype(np.float32),
                                   f0=f0.astype(np.float32),
                                   en=en.astype(np.float32), label=label))
                if split == corpus_io.TRAIN_SPLIT:
                    lo = log_sp.min(axis=0)
                    hi = log_sp.max(axis=0)
                    xmin = lo if xmin is None else np.minimum(xmin, lo)
                    xmax = hi if xmax is None else np.maximum(xmax, hi)
                    f0_by_speaker.setdefault(label, []).append(f0)
                if verbose:
                    print(f"[analyze] {split}/{spk}/"
                          f"{os.path.basename(wav_path)}: {len(f0)} frames, "
                          f"voiced {(f0 > 0).mean():.0%}")

    if xmin is not None:
        corpus_io.save_norm_stats(etc, xmin, xmax)
    # NaN marks speakers with no analyzed training data: conversion to or
    # from them raises instead of applying placeholder f0 statistics
    mu = np.full(len(speakers), np.nan, np.float32)
    sd = np.ones(len(speakers), np.float32)
    for label, f0s in f0_by_speaker.items():
        mu[label], sd[label] = f0_statistics(f0s)
    for label, name in enumerate(speakers):
        if not np.isfinite(mu[label]):
            print(f"[analyze] WARNING: no training utterances for speaker "
                  f"{name!r}; f0 stats unavailable")
    corpus_io.save_f0_stats(etc, mu, sd)
