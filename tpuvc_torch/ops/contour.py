"""Both candidate-extension passes of WORLD's f0 contour.

DIO's and Harvest's contour fixing extend each voiced run into the
unvoiced frames beside it: walking the frames, an unvoiced frame takes the
candidate nearest the previous frame's f0 when its relative error is under
``allowed``.  :func:`extend_scans` runs that walk forward and then backward
over the forward walk's output, which is what the JAX package computes as
``_extend_scan(_extend_scan(f0, c)[::-1], c[::-1])[::-1]``
(``tpuvc/dsp/dio.py:363``, a ``jax.lax.scan``).

CUDA kernel (``csrc/contour.cu``); it replaces no Pallas kernel.  It was
added because the scan, run as a Python loop over frames, launched about
16 small kernels per frame and pass (~38 k for one corpus request of 64
rows x 1201 frames), and the host's launches set the pace while the card
idled.  Bound: the latency of 2N dependent steps per row, not bytes or
operations.  One block per row: one warp walks the frames, a lane per
candidate and one warp-wide minimum a step, while another warp stages the
next tile of f0 and candidates in shared memory, so no global load sits on
the chain; the forward pass's output goes to the result, from which the
backward walk's tiles are staged.  The kernel takes the candidates as a
contiguous ``[B, N, C]``: DIO's, a transpose view of its ``[B, C, N]``
array, are copied once (~2 MB a corpus request, beside a call of ~0.3 s).
Bit-equal to :func:`extend_scans_plain`: one
IEEE division per candidate, the lowest index on ties and a NaN error
rejecting the frame, as ``torch.min`` and ``jnp.argmin`` give.
"""

from __future__ import annotations

import torch

from tpuvc_torch.ops import _build

MAX_CANDS = 32


def _extend_pass(f0: torch.Tensor, cands: torch.Tensor,
                 allowed: float) -> torch.Tensor:
    """One forward walk: f0 [B, N], cands [B, N, C] -> [B, N]."""
    out = torch.empty_like(f0)
    last = torch.zeros_like(f0[:, 0])
    for i in range(f0.shape[1]):
        f0_i, c_i = f0[:, i], cands[:, i]
        err = torch.abs(c_i - last[:, None]) / torch.clamp(
            last, min=1e-6)[:, None]
        e_min, j = torch.min(err, dim=-1)
        ok = (f0_i == 0) & (last > 0) & (e_min < allowed)
        pick = torch.gather(c_i, 1, j[:, None])[:, 0]
        last = torch.where(f0_i > 0, f0_i,
                           torch.where(ok, pick, torch.zeros_like(pick)))
        out[:, i] = last
    return out


def extend_scans_plain(f0: torch.Tensor, cands: torch.Tensor,
                       allowed: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`extend_scans` (same contract)."""
    f0 = _extend_pass(f0, cands, allowed)
    return _extend_pass(f0.flip(-1), cands.flip(1), allowed).flip(-1)


def extend_scans(f0: torch.Tensor, cands: torch.Tensor,
                 allowed: float) -> torch.Tensor:
    """f0 [B, N] float32, cands [B, N, C] float32 -> [B, N]: voiced runs
    extended forward, then backward, into unvoiced frames by the nearest
    candidate whose relative error is under ``allowed``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises) on ``f0`` and a contiguous copy of ``cands`` (no
    copy where it is contiguous already).
    """
    if (f0.dim() != 2 or cands.dim() != 3 or f0.dtype != torch.float32
            or cands.dtype != torch.float32
            or cands.shape[:2] != f0.shape or cands.shape[2] < 1):
        raise ValueError(f"extend_scans needs f0 [B, N] and cands [B, N, C] "
                         f"float32, got {tuple(f0.shape)} {f0.dtype} and "
                         f"{tuple(cands.shape)} {cands.dtype}")
    if f0.device != cands.device:
        raise ValueError(f"extend_scans: f0 on {f0.device}, cands on "
                         f"{cands.device}")
    if f0.device.type == "cpu":
        return extend_scans_plain(f0, cands, allowed)
    if f0.device.type != "cuda" or not f0.is_contiguous():
        raise ValueError("extension kernel needs a contiguous CUDA f0")
    b, n, c = cands.shape
    if c > MAX_CANDS:
        raise ValueError(f"extension kernel is built for at most "
                         f"{MAX_CANDS} candidates, got {c}")
    cands = cands.contiguous()
    out = torch.empty_like(f0)
    _build.launch("tpuvc_extend_scans", f0.device, f0.data_ptr(),
                  cands.data_ptr(), out.data_ptr(), b, n, c, allowed)
    _build.count("extend")
    return out
