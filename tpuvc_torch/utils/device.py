"""The device the port's entry points run on."""

from __future__ import annotations

import torch


def resolve(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.

    The entry points default to the card and never fall back to the CPU:
    a caller who wants the plain PyTorch versions passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpuvc_torch runs on a CUDA card by default and this machine "
            "has none (torch.cuda.is_available() is False); pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
