"""DIO's event stage: per-cell events and their per-block top-2 pairs.

Replaces ``tpuvc/ops/pallas_events.py:event_block_pairs`` (the Pallas
kernel ``_kernel`` with its sorted-pair insert ``_insert_top2``).  For
four event types — negative-going and positive-going zero crossings of
the filtered signal, peaks and dips (zero crossings of its first
difference) — each cell gets a crossing mask, a linear-interpolation
fraction and an event time, and every block of ``stride`` cells keeps the
two largest and the two smallest event times, exact under ties with
multiplicity.

CUDA kernel (``csrc/events.cu``), bound by device-memory bytes: it reads
the [rows, T] bank once and writes 16/stride as much.  A CTA per (row,
tile of 128 blocks) stages its span of the row and a 2-sample halo in
shared memory with coalesced loads; a thread per block sets each type's
events as bits of a mask (a subtraction and two compares per cell and
type), then divides only at the block's first two and last two events:
a type's event times never decrease along the row, so those are its
sorted top-2 pairs (``csrc/events.cu`` states the conditions: a stride
of at most 32, T at most 2^24, every sample of the span below 2^126 in
magnitude; a CTA outside them takes the per-cell insert with the NaN rule
below).  Bit-exact against the plain version: every value is a selection
or the same IEEE operation in the same order (``(i + frac) + off`` and
``v0 / (v0 - v1)``), with no fused multiply-add to contract.

The plain version is the port of the XLA twin, ``tpuvc/dsp/dio.py``
``_channel_tracks`` (its cell stage) and ``_block_top2``, NaN policy
included (:func:`_block_top2`); the kernel follows it, while the JAX
package's own Pallas kernel (interpret mode) makes both slots NaN at one
NaN time.

``top2_block_scans`` replaces ``tpuvc/ops/pallas_events.py:
top2_block_scans``: all eight block-level scans of those pairs (per event
type a prefix top-2 of the max pairs and a suffix bottom-2 of the min
pairs) in one pass, CUDA kernel ``csrc/scan.cu``, one warp per scan.  Its
plain version is the cummax ladders of ``tpuvc/dsp/dio.py``
(``_top2_max_scan``, ``_top2_min_scan_rev``: the JAX package's default
route, per event type).  Both are selections only, so they agree bit for
bit.
"""

from __future__ import annotations

import torch

from tpuvc_torch.ops import _build


def n_blocks(t: int, stride: int) -> int:
    return -(-(t - 1) // stride)


def _block_top2(v: torch.Tensor, stride: int, nb: int, largest: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """[R, L] masked event times -> per-block sorted top-2 ([R, nb] x 2).

    The XLA twin's formulation (``tpuvc/dsp/dio.py:_block_top2``): the
    extreme, then the extreme of the rest after removing one instance of
    it, so a duplicated maximum is its own runner-up.  Its NaN policy too:
    ``amax``/``amin`` propagate a NaN time (an event whose v0 is infinite
    gives inf/inf) and ``argmax``/``argmin`` pick it, so one NaN in a
    block makes the first slot NaN and leaves the extreme of the others in
    the second, two or more make both NaN.
    """
    fill = -torch.inf if largest else torch.inf
    pad = nb * stride - v.shape[-1]
    vb = torch.nn.functional.pad(v, (0, pad), value=fill)
    vb = vb.reshape(v.shape[0], nb, stride)
    red, arg = ((torch.amax, torch.argmax) if largest
                else (torch.amin, torch.argmin))
    m1, am = red(vb, dim=-1), arg(vb, dim=-1)
    lanes = torch.arange(stride, device=v.device)
    rest = torch.where(lanes == am[..., None], fill, vb)
    return m1, red(rest, dim=-1)


def event_block_pairs_plain(bank: torch.Tensor, stride: int
                            ) -> torch.Tensor:
    """bank [R, T] float32 -> [R, 16, nb], nb = ceil((T-1)/stride).

    Row 4*t + {0: block max, 1: second max, 2: block min, 3: second min}
    of event type t in (zc-neg, zc-pos, peaks, dips) order.  Blocks past a
    type's own cell count (T-1 for zero crossings, T-2 for the derivative
    types) hold the fill values -inf/+inf.
    """
    r, t = bank.shape
    nb = n_blocks(t, stride)
    d = bank[:, 1:] - bank[:, :-1]
    rows = []
    for s, off in ((bank, 0.0), (-bank, 0.0), (d, 0.5), (-d, 0.5)):
        v0, v1 = s[:, :-1], s[:, 1:]
        m = (v0 > 0) & (v1 <= 0)
        frac = torch.where(m, v0 / torch.where(m, v0 - v1, 1.0), 0.0)
        cells = torch.arange(s.shape[1] - 1, dtype=torch.float32,
                             device=bank.device)
        tpos = cells + frac + off
        ninf = torch.full_like(tpos, -torch.inf)
        pinf = torch.full_like(tpos, torch.inf)
        p1, p2 = _block_top2(torch.where(m, tpos, ninf), stride, nb, True)
        s1, s2 = _block_top2(torch.where(m, tpos, pinf), stride, nb, False)
        rows += [p1, p2, s1, s2]
    return torch.stack(rows, dim=1)


def event_block_pairs(bank: torch.Tensor, stride: int) -> torch.Tensor:
    """All four event types' per-block top-2 pairs: [R, T] -> [R, 16, nb].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises).
    """
    if stride < 3:
        raise ValueError(f"event stage needs stride >= 3, got {stride}")
    if bank.dim() != 2 or bank.dtype != torch.float32:
        raise ValueError(f"bank must be [R, T] float32, got "
                         f"{tuple(bank.shape)} {bank.dtype}")
    if bank.device.type == "cpu":
        return event_block_pairs_plain(bank, stride)
    if bank.device.type != "cuda" or not bank.is_contiguous():
        raise ValueError("event kernel needs a contiguous CUDA tensor")
    r, t = bank.shape
    nb = n_blocks(t, stride)
    out = torch.empty((r, 16, nb), dtype=torch.float32, device=bank.device)
    _build.launch("tpuvc_event_block_pairs", bank.device, bank.data_ptr(),
                  out.data_ptr(), r, t, stride, nb)
    _build.count("events")
    return out


def top2_max_scan(a1: torch.Tensor, a2: torch.Tensor):
    """Prefix top-2 over blocks (last axis) of sorted (largest, second)
    pairs.  With pre[j] = cummax(a1)[j-1] (-inf at 0):
    p1 = cummax(a1), p2 = max(cummax(min(a1, pre)), cummax(a2)) — exact,
    with multiplicity (see tpuvc/dsp/dio.py:_top2_max_scan)."""
    p1 = torch.cummax(a1, dim=-1).values
    pre = torch.cat([torch.full_like(p1[..., :1], -torch.inf),
                     p1[..., :-1]], dim=-1)
    p2 = torch.maximum(torch.cummax(torch.minimum(a1, pre), dim=-1).values,
                       torch.cummax(a2, dim=-1).values)
    return p1, p2


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(-1), dim=-1).values.flip(-1)


def top2_min_scan_rev(b1: torch.Tensor, b2: torch.Tensor):
    """Suffix bottom-2 of sorted (smallest, second) pairs; mirror of
    top2_max_scan with post[j] = suffix-min over j+1.. (+inf at the end)."""
    s1 = _rev_cummin(b1)
    post = torch.cat([s1[..., 1:], torch.full_like(s1[..., :1], torch.inf)],
                     dim=-1)
    s2 = torch.minimum(_rev_cummin(torch.maximum(b1, post)),
                       _rev_cummin(b2))
    return s1, s2


def top2_block_scans_plain(pairs: torch.Tensor) -> torch.Tensor:
    """[R, 16, nb] block pairs -> the same layout with rows 4t/4t+1 the
    prefix top-2 and rows 4t+2/4t+3 the suffix bottom-2 of event type t:
    the ladders, all four types at once."""
    r, _, nb = pairs.shape
    p1, p2 = top2_max_scan(pairs[:, 0::4], pairs[:, 1::4])     # [R, 4, nb]
    s1, s2 = top2_min_scan_rev(pairs[:, 2::4], pairs[:, 3::4])
    return torch.stack([p1, p2, s1, s2], dim=2).reshape(r, 16, nb)


def top2_block_scans(pairs: torch.Tensor) -> torch.Tensor:
    """All eight block-level scans of ``event_block_pairs``' output:
    [R, 16, nb] -> [R, 16, nb] (any nb; trailing all-fill blocks are inert
    in both directions, so a type's scan may be sliced to its own nb after).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises).
    """
    if pairs.dim() != 3 or pairs.shape[1] != 16 or (
            pairs.dtype != torch.float32):
        raise ValueError(f"pairs must be [R, 16, nb] float32, got "
                         f"{tuple(pairs.shape)} {pairs.dtype}")
    if pairs.device.type == "cpu":
        return top2_block_scans_plain(pairs)
    if pairs.device.type != "cuda" or not pairs.is_contiguous():
        raise ValueError("scan kernel needs a contiguous CUDA tensor")
    r, _, nb = pairs.shape
    out = torch.empty_like(pairs)
    _build.launch("tpuvc_top2_block_scans", pairs.device, pairs.data_ptr(),
                  out.data_ptr(), r, nb)
    _build.count("scan")
    return out
