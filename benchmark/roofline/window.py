"""K3, the windowed frames (CheapTrick): each frame's pitch-adaptive
Hann window, mean removal and window power.

The whole output is written; only the columns of each frame's window
support [w/2 - h, w/2 + h], h = rint(1.5 fs / f0), need reading and
windowing (16 float32 operations per such lane).
"""

import torch

from benchmark.reference.window import support

DEVICE_NAMES = ("windowed_frames_kernel",)
REFERENCE = ("cheaptrick.windowed_frames",)
OPS_LANE = 16


def work(seg_raw, f0, fs, out=None):
    n, w = seg_raw.shape
    lo, hi = support(f0, fs, w)
    cols = int(torch.clamp(hi - lo + 1, min=0).sum())
    return 4 * (n * w + cols + 2 * n), OPS_LANE * cols, 0
