"""K4, the box smoothing (CheapTrick, D4C): each frame's spectrum
averaged over its pitch-dependent width.

The spectrum and widths read once and the result written once; a
multiply and an add per bin for each tap of the frame's span of nonzero
weights (the kernel sums no other).
"""

from benchmark.reference.smooth import box_weights

DEVICE_NAMES = ("box_smooth_kernel",)
REFERENCE = ("spectral.box_smooth",)


def work(ps, width, fs, fft_size, max_width_hz, out=None):
    n, half = ps.shape
    nz = box_weights(width, fs, fft_size, max_width_hz) != 0
    first = nz.int().argmax(dim=1)
    last = nz.shape[1] - 1 - nz.flip(1).int().argmax(dim=1)
    span = (last - first + 1).where(nz.any(dim=1), 0)
    return 4 * (2 * n * half + n), 2 * int(span.sum()) * half, 0
