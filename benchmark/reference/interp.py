"""Linear interpolation on a uniform grid.

Port of ``tpuvc/dsp/interp.py:interp_uniform``.

Frozen plain copy of ``tpuvc_torch/dsp/interp.py`` for the benchmark's
reference: no hand kernel, nothing imported from the port.
"""

from __future__ import annotations

import torch


def interp_uniform(fp: torch.Tensor, x_over_dx: torch.Tensor
                   ) -> torch.Tensor:
    """Linear interp of ``fp`` (last axis, uniform grid) at positions
    ``x_over_dx`` (query coordinate / grid step), clamped at both ends.
    ``x_over_dx`` has ``fp``'s leading shape; indexing follows
    ``torch.gather`` on the last axis."""
    n = fp.shape[-1]
    pos = torch.clamp(x_over_dx, 0.0, n - 1.0)
    i0 = torch.floor(pos).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    w = (pos - i0).to(fp.dtype)
    f0 = torch.gather(fp, -1, i0)
    f1 = torch.gather(fp, -1, i1)
    return f0 * (1.0 - w) + f1 * w
