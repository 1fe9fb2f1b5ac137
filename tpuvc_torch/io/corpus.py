"""Corpus directory conventions (VCC2016-style) and the speaker table.

The port's own copy of ``tpuvc/io/corpus.py``.

Mirrors the reference layout (SURVEY.md L0/L2):
  <root>/wav/Training Set/<SPEAKER>/*.wav
  <root>/wav/Testing Set/<SPEAKER>/*.wav
  <root>/bin/<split>/<SPEAKER>/*.bin     (written by the analyzer)
  <root>/etc/speakers.tsv                (ordered speaker names -> integer ids)
  <root>/etc/xmin.npf, xmax.npf          (Tanhize stats, float32 raw arrays)
  <root>/etc/f0_stats.npz                (per-speaker log-f0 mean/std)
"""

from __future__ import annotations

import glob
import os

import numpy as np

VCC2016_SPEAKERS = [
    "SF1", "SF2", "SF3", "SM1", "SM2", "TF1", "TF2", "TM1", "TM2", "TM3",
]
TRAIN_SPLIT = "Training Set"
TEST_SPLIT = "Testing Set"


def read_speakers(etc_dir: str) -> list[str]:
    path = os.path.join(etc_dir, "speakers.tsv")
    with open(path) as f:
        return [line.strip().split("\t")[0] for line in f if line.strip()]


def write_speakers(etc_dir: str, speakers: list[str]) -> None:
    os.makedirs(etc_dir, exist_ok=True)
    with open(os.path.join(etc_dir, "speakers.tsv"), "w") as f:
        f.write("\n".join(speakers) + "\n")


def speaker_index(speakers: list[str], name: str) -> int:
    try:
        return speakers.index(name)
    except ValueError as e:
        raise KeyError(f"speaker {name!r} not in {speakers}") from e


def list_wavs(corpus_root: str, split: str,
              speaker: str | None = None) -> list[str]:
    pat = os.path.join(corpus_root, "wav", split, speaker or "*", "*.wav")
    return sorted(glob.glob(pat))


def list_bins(corpus_root: str, split: str,
              speaker: str | None = None) -> list[str]:
    pat = os.path.join(corpus_root, "bin", split, speaker or "*", "*.bin")
    return sorted(glob.glob(pat))


def bin_path_for_wav(corpus_root: str, wav_path: str) -> str:
    rel = os.path.relpath(wav_path, os.path.join(corpus_root, "wav"))
    out = os.path.join(corpus_root, "bin", os.path.splitext(rel)[0] + ".bin")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    return out


def save_norm_stats(etc_dir: str, xmin: np.ndarray, xmax: np.ndarray) -> None:
    """Reference format: raw float32 arrays `etc/xmin.npf`, `etc/xmax.npf`."""
    os.makedirs(etc_dir, exist_ok=True)
    xmin.astype(np.float32).tofile(os.path.join(etc_dir, "xmin.npf"))
    xmax.astype(np.float32).tofile(os.path.join(etc_dir, "xmax.npf"))


def load_norm_stats(etc_dir: str) -> tuple[np.ndarray, np.ndarray]:
    xmin = np.fromfile(os.path.join(etc_dir, "xmin.npf"), dtype=np.float32)
    xmax = np.fromfile(os.path.join(etc_dir, "xmax.npf"), dtype=np.float32)
    return xmin, xmax


def save_f0_stats(etc_dir: str, mu: np.ndarray, sigma: np.ndarray) -> None:
    """Per-speaker voiced log-f0 mean/std, indexed by speaker id."""
    os.makedirs(etc_dir, exist_ok=True)
    np.savez(os.path.join(etc_dir, "f0_stats.npz"), mu=mu, sigma=sigma)


def load_f0_stats(etc_dir: str) -> tuple[np.ndarray, np.ndarray]:
    z = np.load(os.path.join(etc_dir, "f0_stats.npz"))
    return z["mu"], z["sigma"]
