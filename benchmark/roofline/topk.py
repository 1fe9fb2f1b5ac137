"""K5, the top-k sum (D4C): each row's sum of its kk largest values.

The rows read once and the sums written once; a compare and a select per
value and round.
"""

DEVICE_NAMES = ("topk_sum_kernel",)
REFERENCE = ("d4c.topk_sum",)


def work(ps, kk, out=None):
    n, c = ps.shape
    return 4 * (n * c + n), 2 * kk * n * c, 0
