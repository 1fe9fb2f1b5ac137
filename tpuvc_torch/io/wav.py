"""Sample-rate conversion on the host.

The port's own copy of ``tpuvc/io/wav.py:resample``: a rational-ratio
polyphase resampler (``scipy.signal.resample_poly``, Kaiser-windowed
low-pass), so a 22.05/44.1/48 kHz recording converts at the pipeline's
16 kHz.  Output length is ceil(len(x) * fs_out / fs_in).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
from scipy.signal import resample_poly


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
