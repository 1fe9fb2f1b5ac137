"""Overlapping centred frames of a batch of signals.

Port of ``tpuvc/ops/framing.py:frame_signal``: out[b, i, j] =
x[b, i*hop - window//2 + j], zero outside the signal.  A strided view
(``Tensor.unfold``) of the zero-padded signal, copied once.
:func:`nonfinite_frames` tells which of those frames hold a NaN or inf
without cutting them.

Frozen plain copy of ``tpuvc_torch/ops/framing.py`` for the benchmark's
reference: no hand kernel, nothing imported from the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def frame_signal(x: torch.Tensor, hop: int, window: int,
                 n_frames: int) -> torch.Tensor:
    """x [B, T] -> [B, n_frames, window]."""
    half = window // 2
    need = (n_frames - 1) * hop + window          # padded samples read
    right = max(0, need - half - x.shape[-1])
    xp = F.pad(x, (half, right))
    return xp.unfold(-1, window, hop)[:, :n_frames].contiguous()


def nonfinite_frames(x: torch.Tensor, hop: int, window: int,
                     n_frames: int) -> torch.Tensor:
    """x [B, T] -> [B, n_frames] bool: frame i of :func:`frame_signal` holds
    a NaN or inf.  A prefix count of the non-finite samples of the padded
    signal, read at the frames' two ends: one pass over the signal, none
    over the frames."""
    half = window // 2
    need = (n_frames - 1) * hop + window
    right = max(0, need - half - x.shape[-1])
    # one more zero in front, so that count[j] counts padded samples [0, j)
    bad = F.pad((~torch.isfinite(x)).to(torch.int32), (half + 1, right))
    count = torch.cumsum(bad, dim=-1)
    start = torch.arange(n_frames, device=x.device) * hop
    return count[:, start + window] > count[:, start]
