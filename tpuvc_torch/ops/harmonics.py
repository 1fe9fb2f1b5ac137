"""Pitch-adaptive harmonic DFT: StoneMask's instantaneous-frequency
refinement, and Harvest's two refinement phases with their glue.

``harmonic_dft`` replaces ``tpuvc/ops/pallas_harmonics.py:
harmonic_dft_pallas`` (the Pallas ``_kernel`` with ``_slot_folded``,
``_slot`` and ``_fold_eo``).  Per frame and candidate slot: a Blackman
window over +-1.5 periods, its discrete-derivative window, the windowed
signal's DFT at the first ``n_harm`` harmonics (Re/Im of the spectrum and
of the derivative spectrum) and the windowed energy.  All harmonic bases
come from one cos/sin pair of the window phase through the triple-angle
and angle-addition recurrence.  ``fold=True`` evaluates every reduction
on the even/odd halves of the segment (the window and cos are even about
the centre, the derivative window and sin odd), which halves the lanes;
f0 is then clamped at :func:`fold_floor`.

``refine_score`` replaces ``refine_score_pallas`` (``_refine_kernel``,
``_refine_math``): per candidate slot, pass 1 at the candidate (with the
derivative window) gives the amplitude-weighted mean of the harmonics'
instantaneous frequencies; a refinement within ``limit`` of the candidate
is accepted, and pass 2 at the refined f0 scores it by harmonic
concentration times the fundamental's share of the first two harmonics.
Empty (f0 <= 0) and rejected slots give 0.

CUDA kernels (``csrc/harmonics.cu``).  ``harmonic_dft`` runs one warp per
(frame, slot), eight per block: lanes b = j * 32 + lane read
``seg[c+b]``/``seg[c-b]`` directly, take one ``sincosf`` each (the
window's cosine is the phase cosine), get the derivative window's
neighbours from the adjacent lanes by shuffle, accumulate 25 sums in
registers and end in one warp reduction after which lane i stores sum
i.  ``refine_score`` runs one block per frame, folds the row into shared
memory once, and gives each candidate slot a warp that runs pass 1, the
glue and pass 2 the same way over only the blocks of 32 folded lanes that
meet the window's support (lanes past it add exactly +-0), writing only
refined f0 and score.  Bound: bytes for ``harmonic_dft`` (each row read
once; the first design, one 256-thread block per (frame, slot), lost most
of its time to that block's 25-sum reduction), operations for
``refine_score`` (both passes over each slot's support).
``adaptive_width`` of the Pallas kernel, an arm measured slower on the
TPU, is not ported.
"""

from __future__ import annotations

import math

import torch

from tpuvc_torch.ops import _build
from tpuvc_torch.ops.arith import rdiv

N_HARM = 6


def fold_floor(w: int, fs: float) -> float:
    """Lowest f0 whose window fits the folded half-width w//2."""
    return 1.5 * fs / (w // 2 - 3)


def _recurrence(cp, sp, n_harm):
    c1 = cp * (4.0 * cp * cp - 3.0)
    s1 = sp * (3.0 - 4.0 * sp * sp)
    ch, sh = c1, s1
    for h in range(n_harm):
        if h:
            ch, sh = ch * c1 - sh * s1, sh * c1 + ch * s1
        yield ch, sh


def _stacked(*per_harmonic):
    """Lists of per-harmonic [N] sums -> [N, n_harm] each (None if empty)."""
    return tuple(torch.stack(v, dim=-1) if v else None for v in per_harmonic)


def _fold_eo(seg):
    """seg [N, W] -> even/odd halves e, o [N, W/2] about c = W/2:
    e[b] = seg[c+b] + seg[c-b] (e[0] = seg[c]), o[b] = seg[c+b] - seg[c-b]."""
    c = seg.shape[-1] // 2
    right = seg[:, c:]                          # seg[c + b]
    left = seg[:, 1:c + 1].flip(-1)             # seg[c - b]
    e = right + left
    return torch.cat([0.5 * e[:, :1], e[:, 1:]], dim=-1), right - left


def _slot_folded(eo, f0, fs, n_harm, with_if):
    """Folded halves (e, o) [N, W/2], f0 [N, 1] clamped at fold_floor ->
    reductions."""
    e, o = eo
    wh = e.shape[-1]
    b = torch.arange(wh, dtype=torch.float32, device=e.device)[None, :]
    half_len = torch.floor(rdiv(1.5 * fs, f0) + 1.0)
    mask = b <= half_len
    phase = (2.0 * math.pi / (3.0 * fs)) * f0 * b
    cp = torch.cos(phase)
    sp = torch.sin(phase)
    zero = torch.zeros((), dtype=torch.float32, device=e.device)
    win = torch.where(mask, 0.42 + 0.5 * cp + 0.08 * (2.0 * cp * cp - 1.0),
                      zero)
    em = torch.where(mask, e, zero)
    om = torch.where(mask, o, zero)
    we = em * win
    wo = om * win
    h0 = torch.where(b == 0.0, 1.0, 0.5)
    en = torch.sum(h0 * (we * we + wo * wo), dim=-1, keepdim=True)
    if with_if:
        nxt = torch.roll(win, -1, dims=-1)      # win[b + 1]
        prv = torch.roll(win, 1, dims=-1)       # win[b - 1]
        col = torch.arange(wh, device=e.device)[None, :]
        edge = (col == 0) | (col >= wh - 1)
        dwin = torch.where(edge, zero, -0.5 * (nxt - prv))
        de = em * dwin
        do = om * dwin
    xre, xim, dre, dim_ = [], [], [], []
    for ch, sh in _recurrence(cp, sp, n_harm):
        xre.append(torch.sum(we * ch, dim=-1))
        xim.append(-torch.sum(wo * sh, dim=-1))
        if with_if:
            dre.append(torch.sum(do * ch, dim=-1))
            dim_.append(-torch.sum(de * sh, dim=-1))
    return (*_stacked(xre, xim, dre, dim_), en[:, 0])


def _slot(seg, f0, fs, n_harm, with_if):
    """Unfolded reductions over all W lanes; f0 [N, 1] > 0."""
    w = seg.shape[-1]
    base = (torch.arange(w, device=seg.device) - w // 2).to(
        torch.float32)[None, :]
    half_len = torch.floor(rdiv(1.5 * fs, f0) + 1.0)
    mask = torch.abs(base) <= half_len
    phase = (2.0 * math.pi / (3.0 * fs)) * f0 * base
    cp = torch.cos(phase)
    sp = torch.sin(phase)
    zero = torch.zeros((), dtype=torch.float32, device=seg.device)
    win = torch.where(mask, 0.42 + 0.5 * cp + 0.08 * (2.0 * cp * cp - 1.0),
                      zero)
    segm = torch.where(mask, seg, zero)
    xw = segm * win
    en = torch.sum(xw * xw, dim=-1)
    if with_if:
        nxt = torch.roll(win, -1, dims=-1)
        prv = torch.roll(win, 1, dims=-1)
        col = torch.arange(w, device=seg.device)[None, :]
        edge = (col == 0) | (col == w - 1)
        dwin = torch.where(edge, zero, -0.5 * (nxt - prv))
        xd = segm * dwin
    xre, xim, dre, dim_ = [], [], [], []
    for ch, sh in _recurrence(cp, sp, n_harm):
        xre.append(torch.sum(xw * ch, dim=-1))
        xim.append(-torch.sum(xw * sh, dim=-1))
        if with_if:
            dre.append(torch.sum(xd * ch, dim=-1))
            dim_.append(-torch.sum(xd * sh, dim=-1))
    return (*_stacked(xre, xim, dre, dim_), en)


def harmonic_dft_plain(seg: torch.Tensor, f0: torch.Tensor, fs: int,
                       n_harm: int = N_HARM, with_if: bool = True,
                       fold: bool = True):
    """Plain PyTorch version of :func:`harmonic_dft` (same contract)."""
    n, w = seg.shape
    k_slots = f0.shape[-1]
    floor = fold_floor(w, float(fs)) if fold else 1.0
    outs = []
    eo = _fold_eo(seg) if fold else None
    for k in range(k_slots):
        f0k = torch.clamp(f0[:, k:k + 1], min=floor)
        if fold:
            outs.append(_slot_folded(eo, f0k, float(fs), n_harm, with_if))
        else:
            outs.append(_slot(seg, f0k, float(fs), n_harm, with_if))
    stack = lambda i: torch.stack([o[i] for o in outs], dim=1)  # noqa: E731
    xre, xim = stack(0), stack(1)
    dre, dim_ = (stack(2), stack(3)) if with_if else (None, None)
    en = torch.stack([o[4] for o in outs], dim=1)
    return xre, xim, dre, dim_, en


def harmonic_dft(seg: torch.Tensor, f0: torch.Tensor, fs: int,
                 n_harm: int = N_HARM, with_if: bool = True,
                 fold: bool = True):
    """Fused windowed harmonic DFT for all frames and candidate slots.

    seg [N, W] frame-centred raw samples (W even), f0 [N, K] candidate
    frequencies.  Returns (x_re, x_im, d_re, d_im, energy): x_*, d_*
    [N, K, n_harm], energy [N, K]; d_* are None when ``with_if`` is False.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises).
    """
    if (seg.dim() != 2 or f0.dim() != 2 or seg.shape[0] != f0.shape[0]
            or seg.dtype != torch.float32 or f0.dtype != torch.float32
            or seg.shape[1] % 2):
        raise ValueError(f"harmonic_dft needs seg [N, W even] and f0 [N, K] "
                         f"float32, got {tuple(seg.shape)} {seg.dtype}, "
                         f"{tuple(f0.shape)} {f0.dtype}")
    if seg.device.type == "cpu" and f0.device.type == "cpu":
        return harmonic_dft_plain(seg, f0, fs, n_harm, with_if, fold)
    if (seg.device.type != "cuda" or f0.device != seg.device
            or not seg.is_contiguous() or not f0.is_contiguous()):
        raise ValueError("harmonic kernel needs contiguous CUDA tensors on "
                         "one device")
    if n_harm != N_HARM:
        raise ValueError(f"harmonic kernel is built for n_harm={N_HARM}")
    n, w = seg.shape
    k_slots = f0.shape[1]
    dev = seg.device
    xre = torch.empty((n, k_slots, n_harm), dtype=torch.float32, device=dev)
    xim = torch.empty_like(xre)
    dre = torch.empty_like(xre) if with_if else None
    dim_ = torch.empty_like(xre) if with_if else None
    en = torch.empty((n, k_slots), dtype=torch.float32, device=dev)
    _build.launch("tpuvc_harmonic_dft", dev, seg.data_ptr(), f0.data_ptr(),
                  xre.data_ptr(), xim.data_ptr(),
                  dre.data_ptr() if with_if else None,
                  dim_.data_ptr() if with_if else None,
                  en.data_ptr(), n, k_slots, w, float(fs), int(fold),
                  int(with_if))
    _build.count("harmonics")
    return xre, xim, dre, dim_, en


def refine_score_plain(seg: torch.Tensor, f0: torch.Tensor, fs: int,
                       floor: float, limit: float, n_harm: int = N_HARM):
    """Plain PyTorch version of :func:`refine_score` (same contract), the
    folded ``_refine_math`` slot by slot."""
    n, w = seg.shape
    eo = _fold_eo(seg)
    c0 = fold_floor(w, float(fs))
    fs = float(fs)
    hh = torch.arange(1, n_harm + 1, dtype=torch.float32,
                      device=seg.device)
    zero = torch.zeros((), dtype=torch.float32, device=seg.device)
    refined_all, score_all = [], []
    for k in range(f0.shape[1]):
        f0k = f0[:, k:k + 1]
        if not bool((f0k > 0.0).any()):          # an empty slot column
            refined_all.append(torch.zeros_like(f0k))
            score_all.append(torch.zeros_like(f0k))
            continue
        xre, xim, dre, dim_, _ = _slot_folded(
            eo, torch.clamp(f0k, min=c0), fs, n_harm, True)
        f0c = torch.clamp(f0k, min=floor)
        power = xre * xre + xim * xim + 1e-20
        amps = torch.where(hh * f0c < fs / 2.0, torch.sqrt(power), zero)
        ifs = hh * f0c + (xre * dim_ - xim * dre) / power * (
            fs / (2.0 * math.pi))
        num = torch.sum(amps * ifs / hh, dim=-1, keepdim=True)
        den = torch.sum(amps, dim=-1, keepdim=True)
        refined = torch.where(den > 0.0, num / torch.clamp(den, min=1e-12),
                              zero)
        ok = ((f0k > 0.0) & (refined > 0.0)
              & (torch.abs(refined - f0k)
                 <= limit * torch.clamp(f0k, min=1e-12)))
        rf = torch.where(ok, torch.clamp(refined, min=floor), zero)
        xre2, xim2, _, _, energy = _slot_folded(
            eo, torch.clamp(rf, min=c0), fs, n_harm, False)
        rfc = torch.clamp(rf, min=floor)
        power2 = xre2 * xre2 + xim2 * xim2 + 1e-20
        amps2 = torch.where(hh * rfc < fs / 2.0, torch.sqrt(power2), zero)
        hw = torch.floor(rdiv(1.5 * fs, rfc) + 1.0)
        fft_size = torch.exp2(2.0 + torch.ceil(torch.log2(2.0 * hw + 1.0)))
        total = torch.sqrt(fft_size * energy[:, None] / 2.0 + 1e-30)
        a1, a2 = amps2[:, 0:1], amps2[:, 1:2]
        score = (torch.sum(amps2, dim=-1, keepdim=True) / total) * (
            a1 / (a1 + a2 + 1e-30))
        refined_all.append(torch.where(ok, refined, zero))
        score_all.append(torch.where(ok, score, zero))
    return torch.cat(refined_all, dim=1), torch.cat(score_all, dim=1)


def refine_score(seg: torch.Tensor, f0: torch.Tensor, fs: int, floor: float,
                 limit: float, n_harm: int = N_HARM):
    """Both Harvest refinement phases and their glue in one pass.

    seg [N, W] frame-centred raw samples (W even), f0 [N, K] candidate
    slots (<= 0 = empty).  Returns (refined [N, K], score [N, K]), 0 for
    empty and rejected slots.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (or raises).
    """
    if (seg.dim() != 2 or f0.dim() != 2 or seg.shape[0] != f0.shape[0]
            or seg.dtype != torch.float32 or f0.dtype != torch.float32
            or seg.shape[1] % 2):
        raise ValueError(f"refine_score needs seg [N, W even] and f0 [N, K] "
                         f"float32, got {tuple(seg.shape)} {seg.dtype}, "
                         f"{tuple(f0.shape)} {f0.dtype}")
    if seg.device.type == "cpu" and f0.device.type == "cpu":
        return refine_score_plain(seg, f0, fs, floor, limit, n_harm)
    if (seg.device.type != "cuda" or f0.device != seg.device
            or not seg.is_contiguous() or not f0.is_contiguous()):
        raise ValueError("refine kernel needs contiguous CUDA tensors on "
                         "one device")
    if n_harm != N_HARM:
        raise ValueError(f"refine kernel is built for n_harm={N_HARM}")
    n, w = seg.shape
    refined = torch.empty_like(f0)
    score = torch.empty_like(f0)
    _build.launch("tpuvc_refine_score", seg.device, seg.data_ptr(),
                  f0.data_ptr(), refined.data_ptr(), score.data_ptr(), n,
                  f0.shape[1], w, float(fs), float(floor), float(limit))
    _build.count("refine")
    return refined, score
