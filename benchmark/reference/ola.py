"""Overlap-add as dense shifted adds.

Port of ``tpuvc/ops/ola.py:overlap_add``, batched.

Frozen plain copy of ``tpuvc_torch/ops/ola.py`` for the benchmark's
reference: no hand kernel, nothing imported from the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[B, N, L] frames at the given hop -> [B, (N-1)*hop + L]."""
    b, n, l = frames.shape
    k = -(-l // hop)                       # hop-chunks per frame
    fr = F.pad(frames, (0, k * hop - l)).reshape(b, n, k, hop)
    out = frames.new_zeros((b, n + k - 1, hop))
    for j in range(k):
        out[:, j:j + n] += fr[:, :, j]
    return out.reshape(b, -1)[:, :(n - 1) * hop + l]
