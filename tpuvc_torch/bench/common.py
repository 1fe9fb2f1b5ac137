"""What the port's microbenchmarks share: the inputs ``bench.py`` builds,
the seeded full-width model, the device call and a clock for device
work."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from tpuvc_torch.convert.pipeline import make_batch_convert_fn
from tpuvc_torch.dsp.constants import DEFAULT_WORLD, WorldConfig
from tpuvc_torch.dsp.synthesis import synthesis_noise
from tpuvc_torch.models.params import init_params, load_model
from tpuvc_torch.utils.config import Architecture


def device_name(device: torch.device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def sync(device: torch.device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_inputs(batch: int, dur_s: float, cfg: WorldConfig = DEFAULT_WORLD,
                y_dim: int = 10, overtone: bool = True) -> tuple:
    """``bench.py``'s inputs as numpy arrays: (xs [B, T], y_trgs, xmin,
    xmax, mu_srcs, sd_srcs, mu_trgs, sd_trgs, seeds).  Row i is a sine at
    110 + 15 i Hz, with its octave unless ``overtone`` is False (the
    signal of ``scripts/compute_only.py``), and noise from
    ``default_rng(0)``; the arithmetic is ``bench.py``'s, so the arrays
    are byte-equal to its."""
    t_samples = int(dur_s * cfg.fs)
    rng = np.random.default_rng(0)
    t = np.arange(t_samples) / cfg.fs
    rows = []
    for i in range(batch):
        x = 0.3 * np.sin(2 * np.pi * (110 + 15 * i) * t)
        if overtone:
            x = x + 0.1 * np.sin(2 * np.pi * 2 * (110 + 15 * i) * t)
        rows.append((x + 0.01 * rng.standard_normal(t_samples)
                     ).astype(np.float32))
    xs = np.stack(rows)
    y_trgs = (np.arange(batch) % y_dim).astype(np.int32)
    xmin = np.full(cfg.sp_dim, -10.0, np.float32)
    xmax = np.full(cfg.sp_dim, 1.0, np.float32)
    mu = np.full(batch, 5.0, np.float32)
    sd = np.ones(batch, np.float32)
    seeds = np.arange(batch, dtype=np.int32)
    return xs, y_trgs, xmin, xmax, mu, sd, mu + 0.3, sd, seeds


def on_device(inputs: tuple, device: torch.device) -> tuple:
    """``make_inputs``' arrays as the device call's arguments: tensors on
    ``device`` (target ids int64), the seeds left on the host, where the
    noise generators are seeded from them."""
    *arrays, seeds = inputs
    put = lambda a: torch.as_tensor(  # noqa: E731
        a, dtype=torch.int64 if a.dtype.kind == "i" else torch.float32,
        device=device)
    return (*map(put, arrays), seeds)


def seeded_model(device: torch.device, **arch_fields):
    """The full-width VAW-GAN in bf16 compute on ``device`` with random
    weights from a ``torch.Generator`` seeded 0, as ``bench.py`` takes
    ``PRNGKey(0)``; returns (model, architecture)."""
    arch = Architecture(compute_dtype="bfloat16", **arch_fields)
    state = init_params(arch, torch.Generator().manual_seed(0),
                        device=device)
    return load_model(arch, state, device), arch


def device_call(model, cfg: WorldConfig = DEFAULT_WORLD):
    """The call ``bench.py`` jits, eagerly: fn(xs, y_trgs, xmin, xmax,
    mu_srcs, sd_srcs, mu_trgs, sd_trgs, seeds) -> the waveforms on the
    device.
    The synthesis noise is drawn inside, on the device, from the host
    ``seeds`` (``synthesis_noise``: one seeded generator per row), as the
    JAX graph draws its noise from ``seeds``."""
    base = make_batch_convert_fn(model, cfg)

    def call(xs, y_trgs, xmin, xmax, mu_srcs, sd_srcs, mu_trgs, sd_trgs,
             seeds):
        n_samples = (xs.shape[-1] // cfg.hop + 1) * cfg.hop
        noise = synthesis_noise(seeds, n_samples, xs.device)
        return base(xs, y_trgs, xmin, xmax, mu_srcs, sd_srcs, mu_trgs,
                    sd_trgs, noise)

    return call


def per_call_s(fn, k: int, device: torch.device) -> float:
    """Seconds per call of ``fn()`` over ``k`` calls back to back: between
    two CUDA events on the card (one synchronise at the end, no copy to the
    host unless ``fn`` makes one), on the host clock elsewhere."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        return (time.perf_counter() - t0) / k
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(k):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / k


def arg(argv: list, i: int, cast, default):
    """Positional argument ``i`` of a bench's command line, as the JAX
    scripts read ``sys.argv``."""
    argv = sys.argv[1:] if argv is None else argv
    return cast(argv[i]) if len(argv) > i else default
