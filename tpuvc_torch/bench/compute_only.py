"""The conversion call without transfers, K eager calls between CUDA
events: the port of ``scripts/compute_only.py``.

  python -m tpuvc_torch.bench.compute_only [batch] [utterance_s] [K] [d2s_impl]

The JAX script runs K iterations of the batched conversion graph inside one
jit program.  PyTorch has no such program: here the port's call (analysis,
VAE, synthesis with its noise drawn on the card from the seeds, float32
waveforms, no encoding) runs K times back to back on the card with no
device-to-host copy and one ``torch.cuda.synchronize()`` at the end, timed
between two CUDA events; the best of 3 such windows, per call.  Eager
PyTorch launches every kernel from the host, so the host's launch work,
and any wait of the host on the card inside the call, lie inside this
window: it is not the JAX figure's "no host" number.  (No perturbation of
the input is needed: nothing is deduplicated between eager calls.)

``d2s_impl`` (xla | pallas) selects the decoder's depth-to-space route
(``Architecture.d2s_impl``); ``pallas`` runs K9 (``ops/d2s.py``).  The
input is the JAX script's: sines at 110 + 15 i Hz without the octave.
Prints one JSON line with the JAX script's keys; its ``metric`` and
``unit`` say what this window holds.
"""

from __future__ import annotations

import json

from tpuvc_torch.bench import common
from tpuvc_torch.dsp.constants import DEFAULT_WORLD
from tpuvc_torch.dsp.world import analysis_kernels
from tpuvc_torch.models.vae import serving_kernels
from tpuvc_torch.ops._build import require_launches, reset_counts
from tpuvc_torch.utils.device import resolve


def measure(batch: int = 128, dur_s: float = 4.0, k: int = 8,
            d2s_impl: str = "xla", device="cuda") -> dict:
    """The JAX script's measurement on ``device`` (the card by default);
    returns its JSON record."""
    dev = resolve(device)
    cfg = DEFAULT_WORLD
    model, arch = common.seeded_model(dev, d2s_impl=d2s_impl)
    args = common.on_device(common.make_inputs(
        batch, dur_s, cfg, arch.y_dim, overtone=False), dev)
    call = common.device_call(model, cfg)

    common.sync(dev)
    reset_counts()
    call(*args)                                # warm
    common.sync(dev)
    require_launches(analysis_kernels(cfg) + serving_kernels(arch), dev,
                     "bench compute_only")

    best = min(common.per_call_s(lambda: call(*args), k, dev)
               for _ in range(3))
    audio_s = batch * dur_s
    return {
        "metric": "conversion call, K eager calls between CUDA events "
                  "(host launches included)",
        "value": round(audio_s / best, 2),
        "unit": "x realtime (s audio / s between the events)",
        "s_per_call": round(best, 4),
        "batch": batch, "utterance_s": dur_s, "k": k,
        "d2s_impl": d2s_impl,
        "device": common.device_name(dev),
    }


def main(argv: list[str] | None = None) -> None:
    print(json.dumps(measure(
        common.arg(argv, 0, int, 128), common.arg(argv, 1, float, 4.0),
        common.arg(argv, 2, int, 8), common.arg(argv, 3, str, "xla"))))


if __name__ == "__main__":
    main()
