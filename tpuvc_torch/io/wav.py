"""WAV I/O and sample-rate conversion on the host.

The port's own copy of ``tpuvc/io/wav.py``: ``resample`` is a
rational-ratio polyphase resampler (``scipy.signal.resample_poly``,
Kaiser-windowed low-pass), so a 22.05/44.1/48 kHz recording converts at
the pipeline's 16 kHz (output length ceil(len(x) * fs_out / fs_in));
``read_wav`` decodes with scipy's RIFF reader (the JAX package's native
PCM16 decoder gives the same float64 samples: int16 / 32768 is exact in
both) and ``write_wav`` writes 16-bit PCM.
"""

from __future__ import annotations

import os
from fractions import Fraction

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

_PCM_SCALE = {
    np.dtype(np.int16): 1.0 / 32768.0,
    np.dtype(np.int32): 1.0 / 2147483648.0,
    np.dtype(np.uint8): 1.0 / 128.0,
}


def resample(x: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    """Resample ``x`` from ``fs_in`` to ``fs_out`` (float64 out)."""
    fs_in = int(fs_in)
    fs_out = int(fs_out)
    if fs_in <= 0 or fs_out <= 0:
        raise ValueError(f"invalid sample rates {fs_in} -> {fs_out}")
    if fs_in == fs_out:
        return np.asarray(x, np.float64)
    fr = Fraction(fs_out, fs_in)
    return resample_poly(np.asarray(x, np.float64), fr.numerator,
                         fr.denominator)


def read_wav(path: str,
             target_fs: int | None = None) -> tuple[np.ndarray, int]:
    """A WAV file -> (float64 mono waveform in [-1, 1], sample rate); with
    ``target_fs`` resampled to that rate (librosa.load(path, sr=...))."""
    fs, data = wavfile.read(path)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if data.dtype in _PCM_SCALE:
        offset = 128.0 if data.dtype == np.uint8 else 0.0
        x = (data.astype(np.float64) - offset) * _PCM_SCALE[data.dtype]
    else:
        x = data.astype(np.float64)
    fs = int(fs)
    if target_fs is not None and fs != target_fs:
        x, fs = resample(x, fs, target_fs), int(target_fs)
    return x, fs


def write_wav(path: str, x: np.ndarray, fs: int) -> None:
    """Write a float waveform in [-1, 1] as 16-bit PCM."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    x = np.clip(np.asarray(x, dtype=np.float64), -1.0, 1.0)
    wavfile.write(path, fs, (x * 32767.0).astype(np.int16))
