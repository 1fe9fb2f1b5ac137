"""WAV I/O and sample-rate conversion on the host.

The port's own copy of ``tpuvc/io/wav.py``: ``resample`` is a
rational-ratio polyphase resampler (``scipy.signal.resample_poly``,
Kaiser-windowed low-pass), so a 22.05/44.1/48 kHz recording converts at
the pipeline's 16 kHz (output length ceil(len(x) * fs_out / fs_in));
``read_wav`` decodes PCM16 mono and stereo with the port's native decoder
(``tpuvc_torch/native``) and every other encoding with scipy's RIFF reader
(both give the same float64 samples for PCM16: int16 / 32768 and the
stereo average are exact in float32 too), and ``write_wav`` writes 16-bit
PCM.  The scipy path scales each channel before averaging them, so a
stereo 8-bit or 32-bit file comes out in [-1, 1] (the JAX package's
fallback averages first and leaves such a file unscaled).
"""

from __future__ import annotations

import os
from fractions import Fraction

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from tpuvc_torch import native

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


def read_wav_scipy(path: str) -> tuple[np.ndarray, int]:
    """A WAV file -> (float64 mono waveform in [-1, 1], sample rate), by
    scipy's RIFF reader."""
    fs, data = wavfile.read(path)
    if data.dtype in _PCM_SCALE:
        offset = 128.0 if data.dtype == np.uint8 else 0.0
        x = (data.astype(np.float64) - offset) * _PCM_SCALE[data.dtype]
        if x.ndim > 1:
            x = x.mean(axis=1)
    else:
        if data.ndim > 1:
            data = data.mean(axis=1)
        x = data.astype(np.float64)
    return x, int(fs)


def read_wav(path: str,
             target_fs: int | None = None) -> tuple[np.ndarray, int]:
    """A WAV file -> (float64 mono waveform in [-1, 1], sample rate); with
    ``target_fs`` resampled to that rate (librosa.load(path, sr=...)).
    PCM16 goes through the native decoder, anything it refuses through
    scipy."""
    fast = native.read_wav_native(path)
    if fast is not None:
        x, fs = fast[0].astype(np.float64), fast[1]
    else:
        x, fs = read_wav_scipy(path)
    if target_fs is not None and fs != target_fs:
        x, fs = resample(x, fs, target_fs), int(target_fs)
    return x, fs


def write_wav(path: str, x: np.ndarray, fs: int) -> None:
    """Write a float waveform in [-1, 1] as 16-bit PCM."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    x = np.clip(np.asarray(x, dtype=np.float64), -1.0, 1.0)
    wavfile.write(path, fs, (x * 32767.0).astype(np.int16))
