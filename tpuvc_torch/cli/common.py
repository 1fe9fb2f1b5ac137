"""Shared CLI plumbing: the device flag.

The port's counterpart of ``tpuvc/cli/common.py``'s ``--platform``: the
card by default, the CPU (every kernel's plain PyTorch version) only when
asked.
"""

from __future__ import annotations

import argparse

import torch

from tpuvc_torch.utils.device import resolve


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch versions)")


def apply_device(args: argparse.Namespace) -> torch.device:
    """The device the flag names; a CUDA device must exist."""
    return resolve(args.device)
