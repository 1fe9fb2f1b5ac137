"""End-to-end conversion throughput on the card: the port of ``bench.py``.

    python bench_torch.py [batch] [utterance_s] [encoding]
      encoding: ulaw8 (default) | pcm12 | int16 | both

Measures audio seconds converted per wall second through the port's
batched converter (``convert/pipeline.py:make_batch_convert_fn`` under
``DEFAULT_WORLD``: DIO + StoneMask, CheapTrick, group-delay D4C, the
full-width VAW-GAN in bf16 with seeded random weights, the f0 transform,
synthesis), with the waveform encoded on the card and copied to the host,
at ``bench.py``'s operating point (128 x 4 s, ulaw8) and with its inputs.
Each call draws its synthesis noise on the card from the seeds
(``dsp/synthesis.py:synthesis_noise``, one generator per row).

Prints ONE JSON line with ``bench.py``'s keys:
  value / wall_s_per_call  the best of three dispatch strategies'
                   medians over ``reps`` repetitions of ``k`` calls
                   (``inline_d2``, ``inline_d3``, ``threaded_d3``; each
                   result copied into a pinned ring and waited on by event,
                   ``pipelined.py``); every strategy's median and
                   [min, max] under ``strategies``
  latency_s        the best of 3 single calls, each synchronised by its
                   copy to the host
  compile_wall_s   the first call's wall time: PyTorch compiles nothing,
                   but on a cold build directory it includes the nvcc build
                   of the kernels, and it includes the pinned ring's
                   allocation
  ulaw_snr_db, pcm12_snr_db  in ``both`` mode, the decoded ulaw8 and pcm12
                   waveforms against the same inputs' int16 drain; null
                   otherwise.  ``both`` also measures the int16 and pcm12
                   drains (``int16``, ``pcm12``; 3 repetitions, fewer if
                   ``reps`` is)
  aot_cache        true: the port's compiled libraries (the kernels and the
                   host-IO library) are always kept by
                   ``utils/aot_cache.py``; PyTorch compiles no graph
  device           the card's name
``vs_baseline`` divides by the 1000x target of ``BASELINE.json``.
"""

from __future__ import annotations

import json
import time

import numpy as np

from tpuvc_torch.bench import common
from tpuvc_torch.bench.pipelined import _measure, primed
from tpuvc_torch.dsp.constants import DEFAULT_WORLD
from tpuvc_torch.ops._build import reset_counts
from tpuvc_torch.ops.ulaw import pcm12_decode, ulaw_decode
from tpuvc_torch.utils.device import resolve

ENCODINGS = ("ulaw8", "pcm12", "int16", "both")


def transfer_snrs(i16: np.ndarray, u8: np.ndarray, p12: np.ndarray
                  ) -> tuple[float, float]:
    """SNR in dB of the decoded ulaw8 and pcm12 codes against the int16
    codes of the same waveforms, as ``bench.py`` computes them (unrounded).
    """
    ref = np.asarray(i16, np.float32) / 32767.0
    num = float(np.sum(ref * ref))
    dec = ulaw_decode(u8)
    snr = 10.0 * np.log10(num / max(float(np.sum((dec - ref) ** 2)), 1e-20))
    dec12 = pcm12_decode(p12, n_samples=ref.shape[-1])
    snr12 = 10.0 * np.log10(
        num / max(float(np.sum((dec12 - ref) ** 2)), 1e-20))
    return float(snr), float(snr12)


def measure(batch: int = 128, dur_s: float = 4.0, encoding: str = "ulaw8",
            k: int = 8, reps: int = 5, device="cuda") -> dict:
    """``bench.py``'s measurement on ``device`` (the card by default);
    returns its JSON record.  ``k`` calls per repetition, ``reps``
    repetitions per strategy (``bench.py``: 8 and 5)."""
    if encoding not in ENCODINGS:
        raise ValueError(f"unknown encoding {encoding!r}")
    dev = resolve(device)
    cfg = DEFAULT_WORLD
    model, arch = common.seeded_model(dev)
    args = common.on_device(
        common.make_inputs(batch, dur_s, cfg, arch.y_dim), dev)
    calls = {enc: common.device_call(model, cfg, enc)
             for enc in ("ulaw8", "pcm12", "int16")}
    primary_enc = "ulaw8" if encoding == "both" else encoding

    # warmup: the first call, its copy to the host, the ring's allocation
    common.sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    primary, first = primed(calls[primary_enc], args)
    first.result()
    compile_wall = round(time.perf_counter() - t0, 1)
    common.require_launches(common.DIO_KERNELS, dev, "bench_torch")

    lat = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        primary(*args).result()
        lat = min(lat, time.perf_counter() - t0)

    best_name, detail = _measure(primary, args, k, reps)
    best = detail[best_name]["median"]
    audio_seconds = batch * dur_s

    out = {}
    snr_db = None
    p12_snr_db = None
    if encoding == "both":
        codes = {}
        for enc in ("int16", "pcm12"):
            fn, first = primed(calls[enc], args)
            codes[enc] = first.result()
            name, det = _measure(fn, args, k, min(3, reps))
            b = det[name]["median"]
            out[enc] = {"best": b, "strategy": name,
                        "x_realtime": round(audio_seconds / b, 2),
                        "vs_baseline": round(audio_seconds / b / 1000.0, 4),
                        "detail": det}
        codes["ulaw8"] = primary(*args).result()
        snr, snr12 = transfer_snrs(codes["int16"], codes["ulaw8"],
                                   codes["pcm12"])
        snr_db, p12_snr_db = round(snr, 1), round(snr12, 1)

    value = audio_seconds / best
    result = {
        "metric": "end-to-end conversion throughput "
                  "(analysis+VAE+synthesis, single chip)",
        "value": round(value, 2),
        "unit": "x realtime (s audio / s wall)",
        "vs_baseline": round(value / 1000.0, 4),
        "batch": batch,
        "utterance_s": dur_s,
        "encoding": primary_enc,
        "ulaw_snr_db": snr_db,
        "pcm12_snr_db": p12_snr_db,
        "wall_s_per_call": round(best, 4),
        "strategy": best_name,
        "strategies": detail,
        "latency_s": round(lat, 4),
        "latency_x_realtime": round(audio_seconds / lat, 2),
        "compile_wall_s": compile_wall,
        "aot_cache": True,
        "device": common.device_name(dev),
    }
    result.update(out)
    return result


def main(argv: list[str] | None = None) -> None:
    batch = common.arg(argv, 0, lambda s: int(float(s)), 128)
    dur_s = common.arg(argv, 1, float, 4.0)
    encoding = common.arg(argv, 2, str, "ulaw8")
    if encoding not in ENCODINGS:
        raise SystemExit(f"unknown encoding {encoding!r}; "
                         "expected ulaw8 | pcm12 | int16 | both")
    print(json.dumps(measure(batch, dur_s, encoding)))


if __name__ == "__main__":
    main()
