"""The port's launch counters (``ops/_build.py``) and the kernel lists
derived from the routing: ``dsp/world.py:analysis_kernels`` and
``models/vae.py:serving_kernels`` against the lists chip_smoke.py's paths
kept by hand, ``require_launches`` on and off the card (only the device's
type and the counters are read, so no card is needed), and one counter
per CUDA launcher, read from the wrappers' sources.

The module imports no JAX.
"""

import ast
import os
import sys

import pytest
import torch

from tpuvc_torch.dsp.constants import WorldConfig
from tpuvc_torch.dsp.world import analysis_kernels
from tpuvc_torch.models.vae import serving_kernels
from tpuvc_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

DIO = ("events", "scan", "extend", "harmonics", "window", "smooth", "topk")
HARVEST = ("events", "scan", "merge", "refine", "extend", "window", "smooth",
           "topk")
# the kernels of each path as chip_smoke.py listed them by hand
HAND_KEPT = {
    "default": DIO + ("norm",),
    "harvest": HARVEST + ("norm",),
    "harvest_decim2": HARVEST + ("norm",),
    "nccf": ("events", "scan", "extend", "harmonics", "window", "smooth",
             "norm"),
    "fused": DIO + ("conv", "d2s", "norm"),
    "pwg": DIO + ("norm",),
}


@pytest.fixture
def zeroed():
    """Counters at 0 before and after, so no other test sees these
    increments."""
    _build.reset_counts()
    yield
    _build.reset_counts()


@pytest.mark.parametrize("path", sorted(HAND_KEPT))
def test_path_kernels_match_the_tables(path):
    assert set(chip_smoke.PATHS) == set(HAND_KEPT)
    world, _, arch = chip_smoke.PATHS[path]
    got = (analysis_kernels(WorldConfig(**world))
           + serving_kernels(chip_smoke.path_arch(path)))
    assert len(set(got)) == len(got)
    assert set(got) == set(HAND_KEPT[path])
    assert set(got) <= set(_build.KERNEL_NAMES)
    assert chip_smoke.path_kernels(path) == got
    assert chip_smoke.path_kernels(path, model=False) == analysis_kernels(
        WorldConfig(**world))


@pytest.mark.parametrize("case", ["cpu", "missing", "launched"])
def test_require_launches(case, zeroed, monkeypatch):
    kernels = ("events", "norm")
    if case == "cpu":
        # off the card the counters are not read at all
        monkeypatch.setattr(_build, "read_counts", lambda: 1 / 0)
        _build.require_launches(kernels, torch.device("cpu"), "here")
        _build.require_launches(kernels, "cpu", "here")
        return
    cuda = torch.device("cuda")
    _build.count("events")
    if case == "missing":
        with pytest.raises(RuntimeError,
                           match=r"here: kernels did not launch: \['norm'\]"):
            _build.require_launches(kernels, cuda, "here")
        return
    _build.count("norm")
    _build.require_launches(kernels, cuda, "here")
    assert _build.read_counts() == dict(
        dict.fromkeys(_build.KERNEL_NAMES, 0), events=1, norm=1)


def _launch_counts():
    """launcher -> the kernel names its wrapper function counts, from every
    function under tpuvc_torch/ops that calls ``_build.launch``."""
    ops = os.path.join(ROOT, "tpuvc_torch", "ops")
    found = {}
    for f in sorted(os.listdir(ops)):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ops, f)).read())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            calls = {"launch": [], "count": []}
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "_build"
                        and node.func.attr in calls):
                    calls[node.func.attr].append(node.args[0].value)
            for name in calls["launch"]:
                found.setdefault(name, []).extend(calls["count"])
    return found


def test_every_launcher_has_a_counter(zeroed):
    found = _launch_counts()
    assert set(found) == set(_build.SIGNATURES)
    assert all(len(names) == 1 for names in found.values()), found
    names = [n for (n,) in found.values()]
    assert sorted(names) == sorted(_build.KERNEL_NAMES)
    assert list(_build.read_counts()) == list(_build.KERNEL_NAMES)
    with pytest.raises(KeyError):
        _build.count("no such kernel")
