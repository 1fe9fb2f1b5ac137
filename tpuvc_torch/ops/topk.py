"""Exact sum of the kk largest values of each row.

Replaces ``tpuvc/ops/pallas_topk.py:topk_sum_pallas`` (the Pallas
``_kernel``): D4C's band statistic needs only sum(top_k(ps, kk)), kk = 21
of 512 bins.  kk rounds of an iterated max: each round adds the row
maximum to the sum and removes one occurrence of it (the lowest column),
so ties count with multiplicity, as a sort would count them, and the sum
is taken in pick order.

CUDA kernel (``csrc/topk.cu``): one warp per row, 16 values per lane in
registers; each round is a shuffle max and a shuffle min over the lowest
column holding it.  Bound: device-memory bytes (the rows are read once;
the rounds stay in registers).  The plain version is the same iterated
max-and-mask loop, and both add in the Pallas kernel's order, so the
three agree bit for bit.
"""

from __future__ import annotations

import torch

from tpuvc_torch.ops import _build

MAX_COLS = 512
launches = 0


def topk_sum_plain(ps: torch.Tensor, kk: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`topk_sum` (same contract)."""
    n, c = ps.shape
    col = torch.arange(c, device=ps.device)
    acc = torch.zeros(n, dtype=torch.float32, device=ps.device)
    ninf = torch.full((), -torch.inf, device=ps.device)
    for _ in range(kk):
        m = torch.amax(ps, dim=-1, keepdim=True)
        acc = acc + m[:, 0]
        first = torch.amin(torch.where(ps >= m, col, c), dim=-1,
                           keepdim=True)
        ps = torch.where(col == first, ninf, ps)
    return acc


def topk_sum(ps: torch.Tensor, kk: int) -> torch.Tensor:
    """[N, C] float32 -> [N]: each row's sum of its kk largest values.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises).
    """
    global launches
    if ps.dim() != 2 or ps.dtype != torch.float32:
        raise ValueError(f"topk_sum needs ps [N, C] float32, got "
                         f"{tuple(ps.shape)} {ps.dtype}")
    n, c = ps.shape
    if not 1 <= kk <= c:
        raise ValueError(f"topk_sum needs 1 <= kk <= {c}, got {kk}")
    if ps.device.type == "cpu":
        return topk_sum_plain(ps, kk)
    if ps.device.type != "cuda" or not ps.is_contiguous():
        raise ValueError("top-k kernel needs a contiguous CUDA tensor")
    if c > MAX_COLS:
        raise ValueError(f"top-k kernel is built for rows of at most "
                         f"{MAX_COLS} values, got {c}")
    out = torch.empty(n, dtype=torch.float32, device=ps.device)
    _build.launch("tpuvc_topk_sum", ps.device, ps.data_ptr(), out.data_ptr(),
                  n, c, kk)
    launches += 1
    return out
