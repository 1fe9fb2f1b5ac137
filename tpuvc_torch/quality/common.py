"""What the port's quality studies share: where they read the architecture
and write their results, the card record attached to every result file,
and the check that their analyses launched the DIO path's kernels."""

from __future__ import annotations

import json
import math
import os
import subprocess

import torch

from tpuvc_torch.dsp.constants import DEFAULT_WORLD
from tpuvc_torch.dsp.world import analysis_kernels
from tpuvc_torch.ops._build import require_launches, reset_counts

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the full-width architecture every study trains (the JAX scripts' file)
ARCH_PATH = os.path.join(ROOT, "configs", "architecture-vawgan-vcc2016.json")
# the result files: the JAX keys, in the port's own files beside the JAX
# package's scale_validation.json / critic_ab.json
RECORD_PATH = os.path.join(ROOT, "scale_validation_torch.json")
CRITIC_AB_PATH = os.path.join(ROOT, "critic_ab_torch.json")
# the default corpora and run directories (the JAX scripts' /tmp/vcc10...)
RUNS_DIR = os.path.join(ROOT, "quality_runs")


def card_record(device: torch.device) -> dict:
    """The device a result was measured on: on the card its name, power
    limit (``nvidia-smi --query-gpu=name,power.limit``) and the PyTorch and
    CUDA versions; elsewhere the device type alone."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": device.type}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    name, _, limit = smi.rpartition(",")
    return {"device": torch.cuda.get_device_name(device),
            "nvidia_smi": smi, "name": name.strip(),
            "power_limit": limit.strip(), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def read_record(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def write_record(path: str, entries: dict, device: torch.device) -> dict:
    """Merge ``entries`` into the result file at ``path`` with the card
    record of ``device`` under ``"card"``; returns the whole file."""
    blob = read_record(path)
    blob.update(entries)
    blob["card"] = card_record(device)
    with open(path, "w") as f:
        json.dump(blob, f, indent=2)
    return blob


def sync(device: torch.device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def start_launches(device: torch.device) -> None:
    """Set every launch counter to 0 before a study's first analysis."""
    sync(device)
    reset_counts()


def require_analysis_launches(device: torch.device, where: str) -> None:
    """On the card, raise unless K1, K7, K2, K3, K4, K5 and the contour
    kernel launched since ``start_launches`` (every study analyses audio
    on the DIO path)."""
    sync(device)
    require_launches(analysis_kernels(DEFAULT_WORLD), device, where)


def non_finite(rec, where: str = "") -> list[str]:
    """The places in a JSON record whose value is not a finite number
    (NaN, infinity or null); booleans and strings pass."""
    if isinstance(rec, dict):
        return [p for k, v in rec.items()
                for p in non_finite(v, f"{where}.{k}")]
    if isinstance(rec, list):
        return [p for i, v in enumerate(rec)
                for p in non_finite(v, f"{where}[{i}]")]
    if rec is None or (isinstance(rec, float) and not math.isfinite(rec)):
        return [where]
    return []
