"""K2, the harmonic DFT (StoneMask): each frame's first harmonics and,
with the derivative window, their instantaneous-frequency terms.

The frames and candidates read once and every output written once; per
frame, slot and folded half-lane 121 float32 operations with the
derivative window and 91 without.
"""

DEVICE_NAMES = ("harmonic_dft_kernel",)
REFERENCE = ("stonemask.harmonic_dft",)
OPS_IF = 121
OPS_NO_IF = 91


def work(seg, f0, fs, n_harm=6, with_if=True, fold=True, out=None):
    n, w = seg.shape
    k = f0.shape[1]
    outs = n * k * ((4 if with_if else 2) * n_harm + 1)
    return (4 * (n * w + n * k + outs),
            (OPS_IF if with_if else OPS_NO_IF) * n * k * (w // 2), 0)
