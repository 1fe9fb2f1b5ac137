"""K7, the block scans: all eight prefix/suffix top-2 scans of K1's pairs.

The pairs read once and the scans written once; one top-2 combine
(3 selections) per block pair.
"""

DEVICE_NAMES = ("top2_block_scans_kernel",)
REFERENCE = ("dio.top2_block_scans",)
OPS_PAIR = 3


def work(pairs, out=None):
    return 4 * 2 * pairs.numel(), OPS_PAIR * pairs.numel() / 2, 0
