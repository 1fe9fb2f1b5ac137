"""True division of a Python number by a tensor.

``num / tensor`` in PyTorch is ``tensor.reciprocal() * num``: two
roundings where JAX and the CUDA kernels round once.  Where the quotient
feeds a discrete decision (a window's half length, a filter's tap count)
one ulp can move a lane in or out, so those quotients go through here.

Frozen plain copy of ``tpuvc_torch/ops/arith.py`` for the benchmark's
reference: no hand kernel, nothing imported from the port.
"""

from __future__ import annotations

import torch


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` with one IEEE rounding, as ``jnp`` computes it."""
    return torch.full_like(t, num) / t
