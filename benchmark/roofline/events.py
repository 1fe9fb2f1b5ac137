"""K1, the event kernel: per-block top-2 event times of a channel bank.

Counted from the bank the algorithm gives it (DIO's and Harvest's
decimated channel banks): the bank read once and the [R, 16, nb] pairs
written once; 13 float32 operations per cell (a difference, then per
event type two compares and a mask bit) and 4 per event time the kernel
computes (for each block and type its first two and last two events).
"""

import torch

DEVICE_NAMES = ("event_block_pairs_kernel",)
REFERENCE = ("dio.event_block_pairs",)
OPS_CELL = 13
OPS_EVENT_TIME = 4


def event_times(bank: torch.Tensor, stride: int) -> int:
    r, t = bank.shape
    nb = -(-(t - 1) // stride)
    d = bank[:, 1:] - bank[:, :-1]
    n = 0
    for s in (bank, -bank, d, -d):
        m = ((s[:, :-1] > 0) & (s[:, 1:] <= 0)).to(torch.uint8)
        m = torch.nn.functional.pad(m, (0, nb * stride - m.shape[1]))
        n += int(m.reshape(r, nb, stride).sum(-1).clamp(max=4).sum())
    return n


def work(bank, stride, out=None):
    """(bytes, float32 operations, TF32 operations)."""
    r, t = bank.shape
    nb = -(-(t - 1) // stride)
    return (4 * (r * t + r * 16 * nb),
            OPS_CELL * r * t + OPS_EVENT_TIME * event_times(bank, stride), 0)
