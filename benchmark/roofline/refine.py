"""K6, Harvest's refinement: both instantaneous-frequency passes and
their glue for every frame and candidate slot.

The frames read once and candidates, refined f0 and scores moved once;
each pass over its window's support only, the folded lanes 0..floor(1.5
fs/f + 1) (past them every term is +-0): pass 1 at the candidate with the
derivative window (121 operations per lane), pass 2 at the refined f0
without it (91).
"""

import torch

from benchmark.reference.arith import rdiv
from benchmark.reference.harmonics import fold_floor

DEVICE_NAMES = ("refine_score_kernel",)
REFERENCE = ("harvest.refine_score",)
OPS_IF = 121
OPS_NO_IF = 91


def work(seg, f0, fs, floor, limit, n_harm=6, out=None):
    n, w = seg.shape
    c = w // 2

    def lanes(f):
        f = torch.clamp(f, min=fold_floor(w, fs))
        return torch.clamp(torch.floor(rdiv(1.5 * fs, f) + 1.0) + 1.0, max=c)

    refined = out[0]
    on1, on2 = f0 > 0, refined > 0
    l1 = float(lanes(f0)[on1].sum())
    l2 = float(lanes(torch.clamp(refined, min=floor))[on2].sum())
    return 4 * (n * w + 3 * f0.numel()), OPS_IF * l1 + OPS_NO_IF * l2, 0
