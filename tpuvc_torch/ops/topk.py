"""Exact sum of the kk largest values of each row.

Replaces ``tpuvc/ops/pallas_topk.py:topk_sum_pallas`` (the Pallas
``_kernel``): D4C's band statistic needs only sum(top_k(ps, kk)), kk = 21
of 512 bins.  kk rounds of an iterated max: each round adds the row
maximum to the sum and removes one occurrence of it (the lowest column),
so ties count with multiplicity, as a sort would count them, and the sum
is taken in pick order, from +0, in non-increasing order of value.

CUDA kernel (``csrc/topk.cu``).  Bound: device-memory bytes (each row read
once).  The first design ran the Pallas body round by round, rescanning
all 16 values of every lane with their column index and running two
5-shuffle warp reductions per round, so instruction issue bound it at 15%
of the bytes bound.  Now each lane of the row's warp sorts its 16 values
once (a register bitonic network), and the kk rounds merge the 32 sorted
lanes: the warp max of the lane heads, then the lowest lane holding it
pops its head, with no column index carried.  Premise: the maxima come
out as the row's values in non-increasing order, the same multiset as the
iterated max-and-mask gives; equal values are interchangeable, and +0 and
-0 (which may come out in either order) leave a sum started at +0
unchanged.  So the kernel, the plain version and the Pallas kernel agree
bit for bit on finite rows with -inf padding.
"""

from __future__ import annotations

import torch

from tpuvc_torch.ops import _build

MAX_COLS = 512


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
    _build.count("topk")
    return out
