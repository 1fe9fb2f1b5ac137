"""Spectrogram thumbnails for TensorBoard (reference util/image.py).

The port's own copy of ``tpuvc/utils/image.py`` (pure numpy).

The reference renders jet-colormapped spectrogram PNGs as tf.summary.image
so training can be eyeballed (SURVEY.md SS2.1).  Here the colormap is pure
numpy (no matplotlib dependency in the hot path) and the writer gets an
HWC uint8 array.
"""

from __future__ import annotations

import numpy as np

# piecewise-linear approximation of the jet colormap
_JET_STOPS = np.array([
    [0.0, 0.0, 0.5], [0.0, 0.0, 1.0], [0.0, 1.0, 1.0],
    [1.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.5, 0.0, 0.0]], np.float32)


def colormap_jet(v: np.ndarray) -> np.ndarray:
    """v in [0,1] (any shape) -> uint8 RGB [..., 3]."""
    v = np.clip(np.asarray(v, np.float32), 0.0, 1.0)
    pos = v * (len(_JET_STOPS) - 1)
    i0 = np.clip(pos.astype(np.int32), 0, len(_JET_STOPS) - 2)
    w = (pos - i0)[..., None]
    rgb = _JET_STOPS[i0] * (1 - w) + _JET_STOPS[i0 + 1] * w
    return (rgb * 255).astype(np.uint8)


def spectrogram_image(frames: np.ndarray, db_range: float = 80.0,
                      log_input: bool = True) -> np.ndarray:
    """[T, D] spectral frames -> HWC uint8 image (freq up, time right).

    frames may be linear power (log_input=False) or already log-scaled.
    """
    s = np.asarray(frames, np.float32)
    if log_input:
        s = 10.0 * np.log10(np.maximum(s, 1e-20))
    else:
        s = 20.0 * s  # normalized log10 units -> dB-ish
    top = np.percentile(s, 99.5)
    v = (s - (top - db_range)) / db_range
    return colormap_jet(v.T[::-1])  # freq axis upward, time rightward
