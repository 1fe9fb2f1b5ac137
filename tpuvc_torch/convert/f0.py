"""Log-linear f0 conversion and the per-speaker statistics it needs.

Port of ``tpuvc/convert/f0.py``.  ``convert_f0`` is batched: lf0' =
(log f0 - mu_src) / sigma_src * sigma_trg + mu_trg on voiced frames;
unvoiced frames stay 0.  ``f0_statistics`` (numpy, on the host) is what
corpus analysis stores in etc/f0_stats.npz.
"""

from __future__ import annotations

import numpy as np
import torch


def f0_statistics(f0s: list[np.ndarray]) -> tuple[float, float]:
    """Voiced log-f0 mean/std over a speaker's utterances; (nan, 1.0)
    when none is voiced (stats unavailable)."""
    voiced = np.concatenate([f[f > 0] for f in f0s]) if f0s else np.array([])
    if voiced.size == 0:
        return float("nan"), 1.0
    lf = np.log(voiced)
    return float(lf.mean()), float(max(lf.std(), 1e-6))


def convert_f0(f0: torch.Tensor, mu_src: torch.Tensor,
               sigma_src: torch.Tensor, mu_trg: torch.Tensor,
               sigma_trg: torch.Tensor) -> torch.Tensor:
    """f0 [B, N]; per-utterance statistics [B]."""
    col = lambda v: v[:, None]  # noqa: E731
    voiced = f0 > 0
    lf = torch.log(torch.where(voiced, f0, 1.0))
    lf2 = ((lf - col(mu_src)) / col(sigma_src) * col(sigma_trg)
           + col(mu_trg))
    return torch.where(voiced, torch.exp(lf2), 0.0)
