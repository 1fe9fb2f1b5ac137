"""Feature normalizer (the reference's ``Tanhize``).

The port's own copy of ``tpuvc/data/normalizer.py``: maps normalized-log-SP
frames into [-1, 1] per dimension from corpus min/max stats (etc/xmin.npf,
xmax.npf): forward(x) = clip((x - xmin) / (xmax - xmin), 0, 1) * 2 - 1;
backward is the inverse.  Works on numpy arrays and on torch tensors (on
the tensor's device; the stats may be tensors too, as the converter's
``_normalize_sp`` and ``_denormalize_sp`` pass them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuvc_torch.io import corpus as corpus_io


@dataclasses.dataclass(frozen=True)
class Tanhize:
    xmin: np.ndarray | torch.Tensor  # [D]
    xmax: np.ndarray | torch.Tensor  # [D]

    @staticmethod
    def from_etc(etc_dir: str) -> "Tanhize":
        xmin, xmax = corpus_io.load_norm_stats(etc_dir)
        return Tanhize(xmin=xmin, xmax=xmax)

    @staticmethod
    def fit(x) -> "Tanhize":
        x = np.asarray(x)
        return Tanhize(xmin=x.min(axis=0).astype(np.float32),
                       xmax=x.max(axis=0).astype(np.float32))

    def save(self, etc_dir: str) -> None:
        corpus_io.save_norm_stats(etc_dir, self.xmin, self.xmax)

    def _stats(self, x):
        """(xmin, span) in x's kind: numpy arrays, or tensors on x's
        device."""
        if torch.is_tensor(x):
            lo, hi = (torch.as_tensor(v, device=x.device)
                      for v in (self.xmin, self.xmax))
            return lo, torch.clamp(hi - lo, min=1e-6)
        lo, hi = np.asarray(self.xmin), np.asarray(self.xmax)
        return lo, np.maximum(hi - lo, 1e-6)

    def forward(self, x):
        lo, span = self._stats(x)
        u = (x - lo) / span
        clip = torch.clamp if torch.is_tensor(x) else np.clip
        return clip(u, 0.0, 1.0) * 2.0 - 1.0

    def backward(self, x):
        lo, span = self._stats(x)
        return (x + 1.0) * 0.5 * span + lo
