"""Per-stage device time of the conversion call: the port of the first half
of ``scripts/bench_stages.py`` (its ``results`` and their sum).

    python -m tpuvc_torch.bench.stages [batch] [dur_s]

Each stage runs K = 8 times back to back on the card between two CUDA
events (``common.per_call_s``); a stage's time is the median of 3 such
windows, per call.  The stages are the JAX script's, on ``bench.py``'s
inputs: dio, stonemask, cheaptrick, d4c_group_delay, d4c_nccf, synthesis
(its noise drawn inside, as the JAX stage draws it), vae(bf16) (normalise,
encode, decode for speaker 3, de-normalise), excitation (the pulse train
and the noise, which synthesis also makes: the sum subtracts it, as the JAX
script does).  The sum leaves out d4c_nccf (the group-delay route is the
default).

Not ported: the JAX script's second half, a batched rfft against a DFT as
float32 and bf16 matmuls on the TPU's matrix unit.  The port's FFTs are
cuFFT through ``torch.fft`` by design (ROADMAP), so there is no DFT
formulation to weigh.

Prints the JAX script's lines, then one JSON line: ``results`` (seconds per
call by stage, the JAX script's keys), ``sum (gd)`` and the operating
point.
"""

from __future__ import annotations

import json

import torch

from tpuvc_torch.bench import common
from tpuvc_torch.convert.pipeline import _denormalize_sp, _normalize_sp
from tpuvc_torch.dsp import cheaptrick, d4c, dio, stonemask, synthesis
from tpuvc_torch.dsp.constants import DEFAULT_WORLD
from tpuvc_torch.dsp.world import analysis_kernels
from tpuvc_torch.ops._build import require_launches, reset_counts
from tpuvc_torch.utils.device import resolve


def timed(fn, dev, k: int = 8, reps: int = 3) -> float:
    """Median over ``reps`` windows of seconds per call of ``fn()`` over
    ``k`` calls back to back, after one warm-up call."""
    fn()
    ts = sorted(common.per_call_s(fn, k, dev) for _ in range(reps))
    return ts[len(ts) // 2]


@torch.no_grad()
def measure(batch: int = 32, dur_s: float = 4.0, k: int = 8, reps: int = 3,
            device="cuda") -> dict:
    """The stage times on ``device`` (the card by default); prints the JAX
    script's lines and returns the JSON record."""
    dev = resolve(device)
    cfg = DEFAULT_WORLD
    model, arch = common.seeded_model(dev)
    xs, _, xmin, xmax, *_ = common.on_device(
        common.make_inputs(batch, dur_s, cfg, arch.y_dim), dev)
    n_frames = cfg.num_frames(xs.shape[-1])
    n_samples = n_frames * cfg.hop
    seeds = range(batch)
    audio_s = batch * dur_s

    reset_counts()
    f0s = dio.dio(xs, cfg.fs, cfg.hop, cfg.f0_floor, cfg.f0_ceil)
    f0r = stonemask.stonemask(xs, f0s, cfg.hop, cfg.fs)
    sps = cheaptrick.cheaptrick(xs, f0r, cfg.hop, cfg.fs, cfg.fft_size)
    aps = d4c.d4c(xs, f0r, cfg.hop, cfg.fs, cfg.fft_size, "group_delay")
    common.sync(dev)
    require_launches(analysis_kernels(cfg), dev, "bench stages")

    def noise():
        return synthesis.synthesis_noise(seeds, n_samples, dev)

    def vae_stage():
        u, en = _normalize_sp(sps, xmin, xmax)
        z_mu, _ = model.encode(u.reshape(batch * n_frames, -1))
        y = torch.full((batch * n_frames,), 3, dtype=torch.int64,
                       device=dev)
        u2 = model.decode(z_mu, y).reshape(batch, n_frames, -1)
        return _denormalize_sp(u2, en, xmin, xmax)

    stages = {
        "dio": lambda: dio.dio(xs, cfg.fs, cfg.hop, cfg.f0_floor,
                               cfg.f0_ceil),
        "stonemask": lambda: stonemask.stonemask(xs, f0s, cfg.hop, cfg.fs),
        "cheaptrick": lambda: cheaptrick.cheaptrick(xs, f0r, cfg.hop, cfg.fs,
                                                    cfg.fft_size),
        "d4c_group_delay": lambda: d4c.d4c(xs, f0r, cfg.hop, cfg.fs,
                                           cfg.fft_size, "group_delay"),
        "d4c_nccf": lambda: d4c.d4c(xs, f0r, cfg.hop, cfg.fs, cfg.fft_size,
                                    "nccf"),
        "synthesis": lambda: synthesis.synthesize(
            f0r, sps, aps, noise(), cfg.fs, cfg.hop, cfg.fft_size),
        "vae(bf16)": vae_stage,
        "excitation": lambda: (synthesis.excitation(f0r, n_samples, cfg.hop,
                                                    cfg.fs), noise()),
    }
    results = {name: timed(fn, dev, k, reps) for name, fn in stages.items()}

    for name, v in results.items():
        print(f"{name:18s}: {v * 1000:8.1f} ms/call "
              f"({audio_s / v:7.0f}x realtime)")
    tot = sum(v for name, v in results.items() if name != "d4c_nccf")
    tot -= results["excitation"]  # excitation is part of synthesis' time
    print(f"{'sum (gd)':18s}: {tot * 1000:8.1f} ms/call "
          f"({audio_s / tot:7.0f}x realtime)", flush=True)
    return {"results": results, "sum (gd)": tot, "batch": batch,
            "utterance_s": dur_s, "k": k,
            "device": common.device_name(dev)}


def main(argv: list[str] | None = None) -> None:
    print(json.dumps(measure(common.arg(argv, 0, int, 32),
                             common.arg(argv, 1, float, 4.0))))


if __name__ == "__main__":
    main()
