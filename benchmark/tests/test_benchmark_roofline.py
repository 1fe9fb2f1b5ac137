"""The roofline counts are chip_smoke.py:bound_of's formulas, fed the
inputs the algorithm gives each stage."""

import pytest
import torch

from benchmark import common, peaks

chip_smoke = pytest.importorskip("chip_smoke")


def _same(name, args, out=None, kernel=None):
    mod = common.load_module("roofline", kernel or name)
    want = chip_smoke.bound_of(name, args, out)["bound_ms"]
    b, ops, tf32 = mod.work(*args, out=out)
    assert 1e3 * peaks.bound_s(b, ops, tf32) == pytest.approx(want, rel=1e-9)


def test_counts_at_the_kernels_shapes():
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    _same("events", (rnd(896, 16000), 20))          # DIO, 128 x 4 s
    _same("scan", (rnd(64, 16, 800),))
    seg, f0 = rnd(2048, 1024), 80 + 400 * torch.rand(2048, 1, generator=g)
    _same("harmonics", (seg, f0, 16000))
    _same("window", (seg, f0[:, 0], 16000))
    width = 200 + 600 * torch.rand(2048, generator=g)
    _same("smooth", (rnd(2048, 513).abs(), width, 16000, 1024, 810.0))
    _same("topk", (rnd(2048, 512), 21))
    seg, f0 = rnd(512, 768), 60 + 500 * torch.rand(512, 10, generator=g)
    f0[:, 7:] = 0.0
    refined = f0 * (1 + 0.01 * torch.rand(512, 10, generator=g))
    _same("refine", (seg, f0, 16000, 63.9, 0.2), (refined, refined))
