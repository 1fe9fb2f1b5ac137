"""Harvest-path conversion throughput on the card: the port of
``scripts/bench_harvest.py``.

    python -m tpuvc_torch.bench.harvest [batch] [utterance_s] [decim]

``bench_torch.py``'s call with ``f0_method="harvest"`` and
``harvest_channel_decim=decim`` (1: WORLD's 152-channel bank, 2: the
76-channel fast mode), the ulaw8 drain and the inline depth-2 strategy:
the median of 5 repetitions of 6 calls, [min, max] under ``spread``.
``harmonics_impl`` and ``refine_impl`` name the route the wrappers took:
"cuda" (the hand kernels) on the card, "plain" on the CPU.  Prints one
JSON line with the JAX script's keys.
"""

from __future__ import annotations

import dataclasses
import json
import time

from tpuvc_torch.bench import common
from tpuvc_torch.bench.pipelined import _pipelined_inline, primed
from tpuvc_torch.dsp.constants import DEFAULT_WORLD
from tpuvc_torch.ops._build import reset_counts
from tpuvc_torch.utils.device import resolve


def measure(batch: int = 32, dur_s: float = 4.0, decim: int = 1,
            k: int = 6, reps: int = 5, device="cuda") -> dict:
    """The JAX script's measurement on ``device`` (the card by default);
    returns its JSON record.  ``k`` calls per repetition, ``reps``
    repetitions (the JAX script's 6 and 5)."""
    dev = resolve(device)
    cfg = dataclasses.replace(DEFAULT_WORLD, f0_method="harvest",
                              harvest_channel_decim=decim)
    model, arch = common.seeded_model(dev)
    args = common.on_device(
        common.make_inputs(batch, dur_s, cfg, arch.y_dim), dev)

    common.sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    convert, first = primed(common.device_call(model, cfg, "ulaw8"), args)
    first.result()
    compile_s = time.perf_counter() - t0
    common.require_launches(common.HARVEST_KERNELS, dev, "bench harvest")

    times = sorted(_pipelined_inline(convert, args, k, 2)
                   for _ in range(reps))
    best = times[len(times) // 2]
    audio_seconds = batch * dur_s
    route = "cuda" if dev.type == "cuda" else "plain"
    return {
        "metric": "harvest-path conversion throughput (single chip)",
        "value": round(audio_seconds / best, 2),
        "unit": "x realtime",
        "harmonics_impl": route,
        "refine_impl": route,
        "channel_decim": decim,
        "batch": batch, "utterance_s": dur_s,
        "wall_s_per_call": round(best, 4),
        "spread": [round(times[0], 4), round(times[-1], 4)],
        "first_call_s_incl_compile": round(compile_s, 1),
        "device": common.device_name(dev),
    }


def main(argv: list[str] | None = None) -> None:
    print(json.dumps(measure(
        common.arg(argv, 0, lambda s: int(float(s)), 32),
        common.arg(argv, 1, float, 4.0), common.arg(argv, 2, int, 1))))


if __name__ == "__main__":
    main()
