#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's analysis and conversion paths on one card.

    python3 chip_smoke.py [--out DIR] [--profile]

Six paths, each a ``WorldConfig`` and architecture of the converter:

  default  DEFAULT_WORLD: DIO (with the fused block scans) + StoneMask,
           CheapTrick, group-delay D4C (the main path; batch 128 x 4 s in
           the rate phase)
  harvest  Harvest f0, CheapTrick, group-delay D4C (batch 32 x 4 s)
  harvest_decim2
           Harvest's fast mode (harvest_channel_decim=2: 76 band channels
           where WORLD's bank has 152), otherwise as harvest (batch 32 x 4 s)
  nccf     DIO + StoneMask, CheapTrick, D4C "nccf" (batch 16 x 4 s)
  fused    DEFAULT_WORLD and the fused-kernel architecture (conv_impl and
           d2s_impl "pallas": fused conv + LayerNorm + LeakyReLU in the
           encoder, fused depth-to-space + LayerNorm + LeakyReLU in the
           decoder); batch 128 x 4 s
  pwg      DEFAULT_WORLD and the default architecture, the waveform made
           by Parallel WaveGAN v1 in bf16 (seeded weights, conditioning
           statistics from the served requests' own features) in place
           of WORLD's synthesis: K13 once a residual layer (batch 64 x
           4 s)

Phases (each prints lines; any failure raises, so the script exits
non-zero and prints no ``"ok"`` line):

  1. device  — require a CUDA card; print its name and, from nvidia-smi,
               its name and power limit; turn TF32 off for the
               comparisons.
  2. build   — compile the thirteen CUDA kernels (tpuvc_torch/csrc: the
               nine of the JAX package's Pallas kernels, the contour
               kernel and Harvest's channel merge, K12, which replace
               jax.lax.scans, the model's LayerNorm + LeakyReLU, K11,
               which XLA fuses, and Parallel WaveGAN's residual layer,
               K13, which has no JAX counterpart) with nvcc
               into build/tpuvc_torch/ and the host-IO library
               (tpuvc_torch/native/io.cc) with g++ into
               build/tpuvc_torch_host/, both through
               tpuvc_torch/utils/aot_cache.py, and load them.
  3. kernels — one analysis per f0 path (default, harvest,
               harvest_decim2) on the card at the rate phase's
               shapes and one fused and one default model call on the
               default batch's envelopes (the default call's ten
               LayerNorm + LeakyReLU sites for K11) record every kernel
               wrapper's real inputs, and one more default analysis of
               16 x 4 s
               around 80 Hz the windowing's (supports that take K3's
               second pass); each kernel then runs on them against its
               plain PyTorch version (error, median ms of single calls of
               both, the kernel's mean ms over 20 launches back to back,
               the card's bound for the work, and a PyTorch library call's
               or chain's time where one computes the same function; the
               fused conv's product also as one float32 F.conv1d with
               cuDNN's TF32 off and on).
 12. vocoder — (run after phase 3) K13 against its plain version on one
               residual layer's bf16 rows at the PWG cell's call (64 x
               96000 positions, dilations 1 and 512: the next x and the
               skip sum within one bf16 step, plus one step of g carried
               through W2), timed as phase 3 times a kernel, with the
               layer as PyTorch's launches as the library yardstick; then
               whole vocoder calls of 64 x 6 s: a bf16 generator must
               launch K13 once a layer (30), a float32 one none; the K13
               and eager bf16 calls' times and waveform errors against the
               float32 generator, and K13's device time per launch in a
               profiled call.
  4. serve   — per path, tpuvc_torch.convert.pipeline.Converter (full-width
               VAW-GAN, seeded random weights, bf16 compute, ulaw8)
               serves six synthetic requests of 1-4 s with every launch
               counter set to 0 just before and read just after; each
               kernel of the path, K11 included, must have launched, and
               each model call must run serving_convs(path) convolutions
               channels-last (Conv._nhwc: 10 default, 5 fused);
               the pwg path's vocoder must launch K13 30 times a vocoder
               call, and no other path may launch it.
               The default path serves the same requests again with
               float32 and pcm12 transfer: decoded on the host, ulaw8
               and pcm12 against float32 clipped to [-1, 1] hold SNR
               >= 30 and >= 50 dB.
               For every path but nccf a 1 s input is also converted on
               the card and on the CPU (plain versions, float32 model and
               vocoder): waveform SNR >= 30 dB.  The fused path then drives the two
               other entry points, counters zeroed and read around each:
               a streamed request through
               tpuvc_torch.convert.streaming.StreamingConverter, and
               tpuvc_torch.cli.analyze.main over a synthetic corpus of 2
               speakers x 2 utterances written under build/.
  5. rate    — per path, one batch through the same Converter: audio
               seconds per wall second (best of 3 calls), latency, per-
               stage times and peak device memory (informational); the
               Harvest path also runs once at the 512 s call budget for
               its peak memory.  ``--profile`` adds a torch.profiler pass
               over one call of every path but nccf
               (device time by kernel, device-busy share); ``--out DIR`` keeps
               the results as JSON there.  The fused path's model stage is
               printed beside the default path's.
  6. train   — the training path on the card, through its entry points:
               a synthetic VCC2016-shaped corpus (10 speakers x 8
               utterances of 1.5 s) analysed by tpuvc_torch.cli.analyze
               (the DIO path's kernels must launch); tpuvc_torch.cli.train
               with configs/architecture-vawgan-vcc2016.json (full width,
               batch 256, n_unroll 5, float32) for 20 streaming steps, then
               resumed from its run directory to step 40 on the resident
               path (checkpoints present, metrics finite, no hand kernel
               launched: training takes the default route); one VAW-GAN
               step on the card and on the CPU from the same seeded
               parameters, batch and noise (loss dict and parameters
               agree; no convolution channels-last); a VAE resident run
               of 200 steps whose loss falls; step times and peak memory
               with cuDNN's TF32 on and off
               (informational; ``--profile`` adds a profiled VAW-GAN and
               VAE step in each setting).  Its run directory and corpus
               (whose 10 speakers also get 2 test utterances each, parallel
               across speakers) stay for phase 7.
  7. convert — the serving CLIs on phase 6's full-width checkpoint, launch
               counters zeroed just before and read just after each call:
               tpuvc_torch.cli.convert --all_pairs --transfer-encoding
               ulaw8 (10 x 2 x 9 = 180 conversions in one batched call; the
               DIO path's seven kernels and K11 must launch; every file
               finite and not silent; wall time and audio s/s), a single
               pair with --f0-method harvest --harvest-decim 2
               --save_spectrogram (K1, K7, K12, K6, the contour kernel, K3,
               K4, K5, K11 must launch; a PNG only where matplotlib is
               installed), a single pair with --streaming (K11 too);
               load_converter on the card and on the CPU from the same
               checkpoint (waveform SNR >= 30 dB, the same noise); and
               tpuvc_torch.cli.evaluate in its round-trip mode (MCD < 8 dB)
               and its conversion mode (every number finite).
  8. parallel — the distributed surfaces (tpuvc_torch.parallel) over a
               mesh of every card, or of the one card twice (a virtual
               mesh: sharding, per-device threads and gather run for
               real), counters zeroed and read around each call:
               Converter.convert_batch(mesh=) on the default path at batch
               128 x 4 s and the fused path at 32 x 4 s (each path's
               kernels launch once per shard; sharded against unsharded
               float32 waveforms SNR >= 40 dB; audio s/s of both, best of
               3); MultiStreamConverter(mesh=) with 8 streams (SNR >= 40
               dB against the unsharded ticks); analyze_sharded of 30 s
               against analyze (relative error < 1e-3; DIO's K1 and K7
               once, the other kernels once per block); a full-width
               VAW-GAN step as two gloo ranks on the card against one
               process (phase 6's rule; step times); a one-rank NCCL world
               (init and all-reduce); cli.convert --all_pairs
               --data_parallel on phase 6's checkpoint against phase 7's
               files (SNR >= 40 dB).
 11. host    — (run after phase 8, on phase 6's corpus and normalizer)
               the host-IO library and the Grain-order input pipeline: a
               second cached_library call must be a hit that compiles
               nothing; every WAV of the corpus decoded by
               tpuvc_torch.native bit-equal to the scipy path; native
               record reads equal to np.fromfile and from_bin_dir equal
               to its memory-mapped load; a 256-row gather with 1 and 8
               threads equal to numpy's; grain_batches over the
               memory-mapped corpus for two epochs (each epoch a
               permutation, labels and rows in its order); then 10
               full-width VAW-GAN steps (batch 256) on the card fed by
               grain_batches through make_trainer(...).train, cuDNN's
               TF32 on as in cli.train (every logged metric finite, no
               hand kernel launched).  Host times of the card's machine
               (informational): ms per WAV native vs scipy, ms per
               256-row gather native vs numpy, grain_batches batches/s.
  9. bench   — the port's two microbenchmarks (tpuvc_torch.bench) at
               reduced repetitions, counters zeroed just before and read
               just after each, each printing its JSON line: compute-only
               at K 4 with d2s_impl xla and pallas (K9), and the stage
               ablation at 32 x 4 s.  Each JSON's keys must equal the JAX
               script's, and each one's kernels must have launched
               (compute-only's include the model's).  Then one default
               call of 128 x 4 s under torch.cuda.set_sync_debug_mode(
               "warn"): the host syncs hidden in it, counted by the port's
               line that caused them.
 10. quality — the quality studies (tpuvc_torch.quality) once each through
               their ``main`` on the card at a reduced size, cuDNN's TF32
               on as in ``cli.train``, counters zeroed just before and read
               just after each, result files under build/: the five
               round-trip classes (each MCD within 0.1 dB of the same
               function on the CPU port, the same noise); scale validation
               on the 10-speaker corpus at 3 training utterances per
               speaker (cli.analyze, 20 cli.train steps, all 450 pairs,
               SF1 -> TM3); convergence_ab --ab model for 300 resident
               steps in 3 milestones per arm (the last milestone's MCD
               must be below the first's in each arm: training learns),
               then convergence_ab --ab critic (the unconditioned and the
               projection-conditioned critic) for 400 resident steps in 2
               milestones per arm, checked the same way (not sooner: the
               unconditioned arm's MCD dips near step 100 and peaks near
               200 before it falls); the per-step critic A/B for 30 steps
               per arm.  Every number must be
               finite, every result's keys the JAX script's, and K1, K7,
               the contour kernel, K2, K3, K4 and K5 must have launched in
               each study.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  The script imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FS = 16000
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_OPS_PER_S = 67e12             # H100 SXM float32, outside tensor cores
TF32_OPS_PER_S = 495e12            # H100 SXM TF32 on the tensor cores, dense
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 on the tensor cores, dense

# name, source, Pallas function it replaces, the path whose launches the
# record reports
KERNELS = [
    ("events", "tpuvc_torch/csrc/events.cu",
     "tpuvc/ops/pallas_events.py:245", "default"),
    ("harmonics", "tpuvc_torch/csrc/harmonics.cu",
     "tpuvc/ops/pallas_harmonics.py:454", "default"),
    ("window", "tpuvc_torch/csrc/window.cu",
     "tpuvc/ops/pallas_window.py:54", "default"),
    ("smooth", "tpuvc_torch/csrc/smooth.cu",
     "tpuvc/ops/pallas_smooth.py:57", "default"),
    ("topk", "tpuvc_torch/csrc/topk.cu",
     "tpuvc/ops/pallas_topk.py:43", "default"),
    ("refine", "tpuvc_torch/csrc/harmonics.cu",
     "tpuvc/ops/pallas_harmonics.py:401", "harvest"),
    ("scan", "tpuvc_torch/csrc/scan.cu",
     "tpuvc/ops/pallas_events.py:208", "fused"),
    ("conv", "tpuvc_torch/csrc/conv.cu",
     "tpuvc/ops/pallas_conv.py:54", "fused"),
    ("d2s", "tpuvc_torch/csrc/d2s.cu",
     "tpuvc/ops/pallas_d2s.py:65", "fused"),
    ("extend", "tpuvc_torch/csrc/contour.cu",
     "none (a jax.lax.scan, tpuvc/dsp/dio.py:363)", "default"),
    ("merge", "tpuvc_torch/csrc/merge.cu",
     "none (a jax.lax.scan, tpuvc/dsp/harvest.py:86)", "harvest"),
    ("norm", "tpuvc_torch/csrc/norm.cu",
     "none (XLA fuses flax.linen.LayerNorm and leaky_relu)", "default"),
]
# kernels whose record sums the sites of one model call (every layer)
SUMMED = ("conv", "d2s", "norm")
# the CUDA functions of tpuvc_torch/csrc, as the profiler names them
KERNEL_FUNCS = ("event_block_pairs_kernel", "harmonic_dft_kernel",
                "windowed_frames_kernel", "box_smooth_kernel",
                "topk_sum_kernel", "refine_score_kernel",
                "top2_block_scans_kernel", "conv_ln_lrelu_kernel",
                "conv_ln_lrelu_row_kernel", "conv_ln_lrelu_tc_kernel",
                "split_tf32_kernel", "d2s_ln_lrelu_kernel",
                "extend_scans_kernel", "norm_lrelu_rows_kernel",
                "norm_lrelu_any_kernel", "merge_channels_kernel",
                "pwg_residual_kernel")

# path -> (WorldConfig fields, rate batch, Architecture fields); the kernels
# each path launches follow from its fields (``path_kernels``) and, on the
# paths of VOCODED, its vocoder's (``models.pwg.vocoder_kernels``)
PATHS = {
    "default": ({}, 128, {}),
    "harvest": ({"f0_method": "harvest"}, 32, {}),
    "harvest_decim2": ({"f0_method": "harvest", "harvest_channel_decim": 2},
                       32, {}),
    "nccf": ({"ap_method": "nccf"}, 16, {}),
    "fused": ({}, 128, {"conv_impl": "pallas", "d2s_impl": "pallas"}),
    "pwg": ({}, 64, {}),
}
# the paths whose waveform Parallel WaveGAN makes (``path_vocoder_state``)
VOCODED = ("pwg",)


def say(*parts) -> None:
    print(*parts, flush=True)


def path_cfg(path: str):
    from tpuvc_torch.dsp.constants import WorldConfig
    return WorldConfig(**PATHS[path][0])


def path_arch(path: str, compute_dtype: str = "bfloat16"):
    from tpuvc_torch.utils.config import Architecture
    return Architecture(compute_dtype=compute_dtype, **PATHS[path][2])


def path_model(path: str, state, dev, compute_dtype: str = "bfloat16"):
    """The full-width VAW-GAN of the path's architecture holding ``state``
    on ``dev``."""
    from tpuvc_torch.models.params import load_model
    return load_model(path_arch(path, compute_dtype), state, dev)


def path_kernels(path: str, model: bool = True) -> tuple:
    """The kernels (``ops._build.KERNEL_NAMES``) a call on ``path`` must
    launch: its analysis's, then, with ``model``, its model's."""
    from tpuvc_torch.dsp.world import analysis_kernels
    from tpuvc_torch.models.vae import serving_kernels
    return analysis_kernels(path_cfg(path)) + (
        serving_kernels(path_arch(path)) if model else ())


def path_vocoder_state(path: str, xs, cfg, dev) -> dict | None:
    """The vocoder's state for a VOCODED path (None on the others):
    ``vocoder_state``'s weights for Parallel WaveGAN v1, its conditioning
    standardized by the mean and deviation of ``xs``'s own features (as
    the published recipe's stats.h5 holds its training corpus's), analysed
    on ``dev`` at the shortest utterance's length."""
    if path not in VOCODED:
        return None
    import torch
    from tpuvc_torch.dsp.world import world_features
    from tpuvc_torch.models import pwg
    spec = pwg.PWGSpec()
    n = min(len(x) for x in xs)
    x = torch.tensor(np.stack([v[:n] for v in xs]), device=dev)
    with torch.no_grad():
        aux = pwg.aux_features(*world_features(x, cfg), cfg, spec)
    frames = aux.transpose(0, 1).reshape(spec.aux_channels, -1).cpu()
    return {**vocoder_state(spec), "aux_mean": frames.mean(dim=1),
            "aux_scale": frames.std(dim=1).clamp(min=1e-3)}


def serving_convs(path: str) -> int:
    """The convolutions one serving encode + decode of the path's model
    runs channels-last (``models/vae.py:Conv._nhwc``): the decoder's, and
    the encoder's unless K8 runs them (10 on the default architecture, 5
    fused)."""
    arch = path_arch(path)
    return len(arch.generator.kernel) + (
        0 if arch.conv_impl == "pallas" else len(arch.encoder.kernel))


def unlaunched(launches: dict, path: str = "default",
               model: bool = True) -> list:
    """The kernels of ``path_kernels(path, model)`` with no launch in
    ``launches`` (a ``read_counts()`` record)."""
    return [k for k in path_kernels(path, model) if launches[k] == 0]


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); the port's kernels run only on the card")
    if not os.path.isdir(os.path.join(ROOT, "tpuvc_torch")):
        raise SystemExit("chip_smoke: tpuvc_torch/ not found beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, ROOT)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[1 device] torch.cuda: {name} (count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda})")
    say("[1 device] nvidia-smi --query-gpu=name,power.limit:")
    say(smi)
    say("[1 device] TF32 off for matmul and cuDNN during the comparisons")
    return name, smi


def phase_build():
    from tpuvc_torch import native
    from tpuvc_torch.ops import _build
    for lib, tool in ((_build, "nvcc"), (native, "g++")):
        t0 = time.perf_counter()
        path = lib.build(**({"verbose": True} if lib is _build else {}))
        lib.lib()
        say(f"[2 build] {os.path.relpath(path, ROOT)} ready in "
            f"{time.perf_counter() - t0:.3f} s ({tool} "
            f"{'ran' if lib.build_seconds is not None else 'cached'})")


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of fn() in ms, from CUDA events, after a warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


B2B_REPS = 20


def back_to_back(fn):
    """fn() B2B_REPS times in a row, to time between one pair of events: a
    single call's window also holds the wrapper's host work (allocations,
    the ctypes call), which the card hides behind the previous launch when
    the calls come back to back.  Over B2B_REPS, the mean time per call; it
    reads the host's enqueue time instead where that is the longer."""
    def run():
        for _ in range(B2B_REPS):
            fn()
    return run


# --- synthetic speakers and assets -------------------------------------

SPEAKERS = [f"S{i}" for i in range(10)]
F0_BASE = [115.0, 215.0, 135.0, 190.0, 105.0, 235.0, 125.0, 205.0, 145.0,
           225.0]


def utterance(rng, spk: int, dur_s: float,
              f0_base: float | None = None) -> np.ndarray:
    """A vowel-like utterance of speaker ``spk``: vibrato f0 around
    ``f0_base`` (the speaker's F0_BASE by default), two formants and a
    spectral tilt (tpuvc/data/synthetic.py's style)."""
    n = int(dur_s * FS)
    t = np.arange(n) / FS
    f0b = F0_BASE[spk] if f0_base is None else f0_base
    f0 = f0b * (1.0 + 0.03 * np.sin(2 * np.pi * 2.5 * t)
                + 0.02 * rng.standard_normal())
    phase = 2 * np.pi * np.cumsum(f0) / FS
    formants = (480.0 + 30.0 * spk, 1500.0 + 90.0 * spk)
    h = np.arange(1, int(4000 / f0b) + 1)[:, None]
    gain = sum(1.0 / (1.0 + ((h * f0b - fc) / 300.0) ** 2) for fc in formants)
    gain = (0.2 + gain) * 10.0 ** (-5.0 * np.log2(h) / 20.0) / h ** 0.3
    x = np.sum(gain * np.sin(h * phase[None]
                             + rng.uniform(0, 2 * np.pi, h.shape)), axis=0)
    x += 0.01 * rng.standard_normal(n)
    ramp = np.minimum(np.arange(n) / (0.02 * FS), 1.0)
    x *= ramp * ramp[::-1]
    return (0.4 * x / np.max(np.abs(x))).astype(np.float32)


def make_assets(xs, spk_ids, cfg, device):
    """Tanhize range and per-speaker log-f0 statistics from an analysis of
    the utterances themselves, as corpus analysis would compute them."""
    from tpuvc_torch.convert.pipeline import EPSILON, ConverterAssets
    from tpuvc_torch.dsp.world import analyze_batch
    t = max(len(x) for x in xs)
    f0, sp, _ = analyze_batch(np.stack([np.pad(x, (0, t - len(x)))
                                        for x in xs]), cfg, device=device)
    f0, sp = f0.cpu().numpy(), sp.cpu().numpy()
    logs, lf = [], {}
    for i, x in enumerate(xs):
        n = len(x) // cfg.hop + 1
        s = sp[i, :n] + EPSILON
        logs.append(np.log10(s / s.sum(-1, keepdims=True)))
        v = f0[i, :n][f0[i, :n] > 0]
        lf.setdefault(spk_ids[i], []).append(np.log(v))
    logs = np.concatenate(logs)
    mu = np.full(len(SPEAKERS), np.nan)
    sd = np.ones(len(SPEAKERS))
    for s, v in lf.items():
        v = np.concatenate(v)
        if v.size:
            mu[s], sd[s] = v.mean(), max(v.std(), 1e-3)
    for s in range(len(SPEAKERS)):
        if not np.isfinite(mu[s]):
            mu[s] = math.log(F0_BASE[s])
    return ConverterAssets(
        xmin=np.percentile(logs, 1, axis=0).astype(np.float32),
        xmax=np.percentile(logs, 99, axis=0).astype(np.float32),
        f0_mu=mu.astype(np.float32), f0_sigma=sd.astype(np.float32),
        speakers=list(SPEAKERS))


def batch_of(rng, batch: int, dur_s: float):
    src = [i % 10 for i in range(batch)]
    return [utterance(rng, s, dur_s) for s in src], src


# --- phase 3: every kernel on its real inputs ---------------------------

@contextlib.contextmanager
def spy(module, name: str, calls: list):
    """Record the arguments of every call of ``module.name``."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def capture_inputs(dev, dur_s: float, batches: dict):
    """path -> kernel -> [(args, kwargs)] of each wrapper call made by one
    analysis of ``batches[path]`` utterances on ``dev``; and the default
    batch's envelopes."""
    from tpuvc_torch.dsp import (cheaptrick, d4c, dio, harvest, spectral,
                                 stonemask, world)
    sites = [(dio, "event_block_pairs", "events"),
             (stonemask, "harmonic_dft", "harmonics"),
             (cheaptrick, "windowed_frames", "window"),
             (spectral, "box_smooth", "smooth"),
             (d4c, "topk_sum", "topk"),
             (harvest, "refine_score", "refine"),
             (dio, "top2_block_scans", "scan"),
             (dio, "extend_scans", "extend"),
             (harvest, "extend_scans", "extend"),
             (harvest, "merge_channels", "merge")]
    rng = np.random.default_rng(2)
    out, sp = {}, None
    for path, batch in batches.items():
        calls = {k: [] for _, _, k in sites}
        xs, _ = batch_of(rng, batch, dur_s)
        with contextlib.ExitStack() as stack:
            for mod, attr, k in sites:
                stack.enter_context(spy(mod, attr, calls[k]))
            feats = world.analyze_batch(np.stack(xs), path_cfg(path),
                                        device=dev)
        out[path] = calls
        if path == "default":
            sp = feats.sp
    return out, sp


# CheapTrick's window spans 3 periods: below ~94.5 Hz at 16 kHz it covers
# more than 512 columns, and K3 takes a second pass over the frame
TWO_PASS_F0 = 80.0


def capture_two_pass(dev, dur_s: float, batch: int):
    """The CheapTrick windowing call of one default analysis of ``batch``
    utterances around a TWO_PASS_F0 base f0."""
    from tpuvc_torch.dsp import cheaptrick, world
    rng = np.random.default_rng(4)
    xs = [utterance(rng, i % len(SPEAKERS), dur_s, TWO_PASS_F0)
          for i in range(batch)]
    calls = []
    with spy(cheaptrick, "windowed_frames", calls):
        world.analyze_batch(np.stack(xs), path_cfg("default"), device=dev)
    return calls[0]


def model_frames(sp):
    """The frames of ``sp`` [B, N, 513], Tanhize-normalised by their own
    min/max, [B * N, 513], and a speaker for each."""
    import torch
    from tpuvc_torch.convert import pipeline
    b, n, half = sp.shape
    s = sp + pipeline.EPSILON
    log = torch.log10(s / s.sum(-1, keepdim=True)).reshape(b * n, half)
    u, _ = pipeline._normalize_sp(sp.reshape(b * n, half), log.amin(0),
                                  log.amax(0))
    return u, torch.arange(b * n, device=sp.device) % len(SPEAKERS)


def capture_model_inputs(state, sp, dev) -> dict:
    """kernel -> [(args, kwargs)] of the fused layers' wrapper calls in one
    encode + decode of the fused model (bf16 compute) on the frames of
    ``sp`` (``model_frames``)."""
    import torch
    from tpuvc_torch.models import vae
    model = path_model("fused", state, dev)
    u, y = model_frames(sp)
    calls = {"conv": [], "d2s": []}
    with torch.no_grad(), spy(vae, "conv_ln_lrelu", calls["conv"]), \
            spy(vae, "d2s_ln_lrelu", calls["d2s"]):
        z, _ = model.encode(u)
        model.decode(z, y)
    return calls


def capture_norm_inputs(state, sp, dev) -> list:
    """[(args, kwargs)] of K11's sites, NORM_SITES: the LayerNorm.lrelu
    calls of one encode + decode of the default model (bf16 compute) on
    the frames of ``sp``, each h as the model gives it (contiguous rows:
    the convolutions write their outputs channels-last)."""
    import torch
    from tpuvc_torch.models import vae
    model = path_model("default", state, dev)
    u, y = model_frames(sp)
    calls = []
    with torch.no_grad(), spy(vae.LayerNorm, "lrelu", calls):
        model.decode(model.encode(u)[0], y)
    return [((h, ln.weight, ln.bias, slope), {})
            for (ln, h, slope), _ in calls]


def _bound(nbytes: float, ops: float, tf32_ops: float = 0.0,
           bf16_ops: float = 0.0) -> dict:
    """The least time the card takes to move nbytes and do ops float32
    operations (plus tf32_ops and bf16_ops on the tensor cores), in ms,
    which of the two bounds it, and both times."""
    tb = 1e3 * nbytes / HBM_BYTES_PER_S
    to = 1e3 * (ops / FP32_OPS_PER_S + tf32_ops / TF32_OPS_PER_S
                + bf16_ops / BF16_OPS_PER_S)
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes_ms": tb, "ops_ms": to}


# float32 operations per element, counted from each kernel's source
# (a transcendental counts as one): events per cell of the bank (a
# difference, then per type two compares and a mask bit) and per event
# time the kernel computes (a subtraction, the division, two additions:
# for each block and type its first two and last two events); the folded
# harmonic pass per half-lane with and without the derivative window;
# the window per lane; topk per value and round; smooth per tap; the
# block scans one top-2 combine (3 selections) per block pair; a
# LayerNorm + LeakyReLU epilogue per value (bias, sum, centre, square-add,
# scale, gamma, beta, select) besides the convolution's 2 K Cin per output.
OPS_EVENTS_CELL = 13
OPS_EVENT_TIME = 4
OPS_HARM_IF = 121
OPS_HARM_NO_IF = 91
OPS_WINDOW_LANE = 16
OPS_SCAN_PAIR = 3
OPS_LN_VALUE = 8
OPS_EXTEND_CAND = 4
# K12 per channel and frame: the mean (3 adds, a multiply), the deviation
# (4 subtractions, 4 absolute values, 3 maxima, a clamp, a division), 9
# gate comparisons and their 2 band multiplies, the candidate's select,
# the merge test (2 comparisons, a subtraction, an absolute value, a
# clamp, a multiply, a comparison), the closing mean (a clamp, a
# division) and the run's 2 additions and 4 selects
OPS_MERGE_CHANNEL = 44
# K13 on the float32 cores per gated value: tanh, exp, the sigmoid's add
# and reciprocal, the product (the epilogue's few adds an output value are
# left out: both are under 1% of the products' tensor-core time)
OPS_PWG_GATE = 5
WINDOW_ONE_PASS_QUADS = 32 * 4     # csrc/window.cu: 32 lanes x kSlots


def event_times(bank, stride: int) -> int:
    """The event times K1 computes on ``bank``: per block and event type,
    min(events, 4) (its first two and last two)."""
    import torch
    r, t = bank.shape
    nb = -(-(t - 1) // stride)
    d = bank[:, 1:] - bank[:, :-1]
    n = 0
    for s in (bank, -bank, d, -d):
        m = ((s[:, :-1] > 0) & (s[:, 1:] <= 0)).to(torch.uint8)
        m = torch.nn.functional.pad(m, (0, nb * stride - m.shape[1]))
        n += int(m.reshape(r, nb, stride).sum(-1).clamp(max=4).sum())
    return n


def bound_of(name: str, args, out) -> dict:
    import torch
    from tpuvc_torch.ops.arith import rdiv
    from tpuvc_torch.ops.harmonics import fold_floor
    from tpuvc_torch.ops.smooth import box_weights
    from tpuvc_torch.ops.window import support
    f4 = 4.0
    if name == "events":
        bank, stride = args
        r, t = bank.shape
        nb = -(-(t - 1) // stride)
        return _bound(f4 * (r * t + r * 16 * nb),
                      OPS_EVENTS_CELL * r * t
                      + OPS_EVENT_TIME * event_times(bank, stride))
    if name == "harmonics":
        seg, f0 = args[:2]
        n, w = seg.shape
        k = f0.shape[1]
        return _bound(f4 * (n * w + n * k + n * k * 25),
                      OPS_HARM_IF * n * k * (w // 2))
    if name == "window":
        # the whole output is written, but only the columns of each frame's
        # window support need reading and windowing; the full-row count
        # (every column read) beside it
        seg, f0, fs = args
        n, w = seg.shape
        lo, hi = support(f0, fs, w)
        cols = int((hi - lo + 1).clamp(min=0).sum())
        # frames whose support spans WINDOW_ONE_PASS_QUADS float4s or more
        # take the kernel's second pass (csrc/window.cu)
        quads = torch.where(lo <= hi, hi // 4 - lo // 4, -1)
        return {**_bound(f4 * (n * w + cols + 2 * n),
                         OPS_WINDOW_LANE * cols),
                "bound_full_row_ms": _bound(f4 * (2 * n * w + 2 * n),
                                            OPS_WINDOW_LANE * n * w)[
                                                "bound_ms"],
                "two_pass_frames": int(
                    (quads >= WINDOW_ONE_PASS_QUADS).sum())}
    if name == "smooth":
        ps, width, fs, fft_size, max_w = args
        n, half = ps.shape
        # a multiply and an add per bin for each tap of the frame's span
        # of nonzero weights (the kernel sums no other)
        nz = box_weights(width, fs, fft_size, max_w) != 0
        first = nz.int().argmax(dim=1)
        last = nz.shape[1] - 1 - nz.flip(1).int().argmax(dim=1)
        span = torch.where(nz.any(dim=1), last - first + 1, 0)
        return _bound(f4 * (2 * n * half + n),
                      2 * int(span.sum()) * half)
    if name == "topk":
        ps, kk = args
        n, c = ps.shape
        return _bound(f4 * (n * c + n), 2 * kk * n * c)
    if name == "refine":
        # each pass over its window's support, folded lanes 0..floor(1.5
        # fs/f + 1) (past it every term is +-0): pass 1 at the candidate,
        # pass 2 at the refined f0, each clamped as the kernel clamps it;
        # the count over all w/2 lanes of every pass beside it
        seg, f0, fs, floor = args[:4]
        n, w = seg.shape
        c = w // 2

        def lanes(f):
            f = torch.clamp(f, min=fold_floor(w, fs))
            return torch.clamp(torch.floor(rdiv(1.5 * fs, f) + 1.0) + 1.0,
                               max=c)
        on1, on2 = f0 > 0, out[0] > 0
        l1 = float(lanes(f0)[on1].sum())
        l2 = float(lanes(torch.clamp(out[0], min=floor))[on2].sum())
        nbytes = f4 * (n * w + 3 * f0.numel())
        return {**_bound(nbytes, OPS_HARM_IF * l1 + OPS_HARM_NO_IF * l2),
                "bound_all_lanes_ms": _bound(
                    nbytes, c * (OPS_HARM_IF * int(on1.sum())
                                 + OPS_HARM_NO_IF * int(on2.sum())))[
                                     "bound_ms"]}
    if name == "scan":
        (pairs,) = args
        return _bound(f4 * 2 * pairs.numel(),
                      OPS_SCAN_PAIR * pairs.numel() / 2)
    if name == "conv":
        # the products on the tensor cores in split TF32 (three TF32
        # products for each float32 one), the epilogue on float32 cores;
        # the float32 FMA count of the first design beside it
        x, w, stride = args[0], args[1], args[5]
        k, cin, cout = w.shape
        n_out = x.shape[0] * -(-x.shape[1] // stride) * cout
        nbytes = (x.element_size() * x.numel()
                  + f4 * (w.numel() + 3 * cout + n_out))
        return {**_bound(nbytes, OPS_LN_VALUE * n_out,
                         3 * 2 * k * cin * n_out),
                "fp32_ops_ms": _bound(nbytes, (2 * k * cin + OPS_LN_VALUE)
                                      * n_out)["ops_ms"]}
    if name == "d2s":
        x, c = args[0], args[1].shape[0]
        e = x.element_size()
        return _bound(e * (2 * x.numel() + 2 * c), OPS_LN_VALUE * x.numel())
    if name == "norm":
        # one read and one write of the activations (4 B a value in
        # bfloat16), gamma and beta in float32
        x, c = args[0], args[1].shape[0]
        return _bound(2 * x.element_size() * x.numel() + f4 * 2 * c,
                      OPS_LN_VALUE * x.numel())
    if name == "merge":
        # every track read once, the channels' frequencies, the [B, N, K]
        # candidates written once
        tracks = args[0]
        b, c, _, n = tracks.shape
        return _bound(f4 * (tracks.numel() + c + out.numel()),
                      OPS_MERGE_CHANNEL * b * c * n)
    if name == "pwg":
        # a position's x, c and skip read and its skip and next x written
        # once (bf16), the weights once; both products on the tensor cores
        # in bf16 (2 K N a position each), the gate on the float32 cores
        x, c, skip, ops = args[:4]
        pos = x.shape[0] * x.shape[1]
        nbytes = (x.element_size() * pos * (2 * x.shape[2] + c.shape[-1]
                                            + 2 * skip.shape[-1])
                  + sum(v.element_size() * v.numel() for v in ops))
        k1, n1 = ops.w1.shape[1], ops.w1.shape[0]
        k2, n2 = ops.w2.shape[1], ops.w2.shape[0]
        return _bound(nbytes, OPS_PWG_GATE * k2 * pos,
                      bf16_ops=2 * (k1 * n1 + k2 * n2) * pos)
    if name == "extend":
        # bound by the latency of the 2N steps each row walks one after
        # another, which has no time of its own here; the bytes and
        # operations (f0 and the candidates read once, the result written
        # once; per candidate and step of both passes a subtraction, an
        # absolute value, a division and a comparison) are a side key
        b, n, c = args[1].shape
        side = _bound(f4 * (2 * b * n + b * n * c),
                      OPS_EXTEND_CAND * 2 * b * n * c)
        return {"bound_ms": None, "bound_by": "latency (2N dependent steps)",
                "dependent_steps": 2 * n,
                "throughput_bound_ms": side["bound_ms"]}
    raise KeyError(name)


def _close(name, got, ref, rtol, atol):
    import torch
    err = (got - ref).abs()
    if not bool(torch.isfinite(got).all()) or bool(
            (err > atol + rtol * ref.abs()).any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err.max().item():.3e})")
    return err.max().item()


def compare(name: str, got, ref) -> tuple[float, str]:
    """Hold a kernel's outputs against its plain version's; returns the
    max abs error and the tolerance applied."""
    import torch
    if name in ("events", "topk", "scan", "smooth", "extend", "merge"):
        # selections, and sums added in the same order (smooth: the same
        # separately rounded products and sums, zero-weight taps skipped;
        # extend, merge: the same IEEE operations and comparisons in the
        # same order): bit-equal
        if not torch.equal(got, ref):
            raise AssertionError(f"{name}: kernel is not bit-equal to its "
                                 "plain version")
        return 0.0, "bit-equal"
    if name == "harmonics":
        # block tree vs torch.sum reduction order, as the CPU tests state
        err = 0.0
        for g, r in zip(got, ref):
            if r is not None:
                err = max(err, _close(name, g, r, 1e-4,
                                      1e-4 * r.abs().max().item()))
        return err, "rtol 1e-4, atol 1e-4*max"
    if name == "window":
        return (max(_close(name, got[0], ref[0], 1e-5, 1e-6),
                    _close(name + " power", got[1], ref[1], 1e-5, 0.0)),
                "rtol 1e-5, atol 1e-6")
    if name == "conv":
        # float32 sums of up to K*Cin products in another order, scaled by
        # the row's 1/std in the norm (TF32 off for the plain version)
        return _close(name, got, ref, 1e-4, 1e-4), "rtol 1e-4, atol 1e-4"
    if name in ("d2s", "norm"):
        # float32 math agreeing to rounding, then one bfloat16 rounding:
        # at most one bfloat16 step (2^-7 of the value) apart
        return (_close(name, got.float(), ref.float(), 8e-3, 1e-5),
                "rtol 8e-3, atol 1e-5 (one bfloat16 step)")
    if name == "refine":
        # the accept gate |refined - f0| <= 0.2 f0 is a threshold on a sum
        # taken in another order: a slot on its edge may flip; at most
        # 1e-4 of the candidate slots may.  Refined f0 as the CPU tests
        # bound it; the score's harmonic sums cancel on noisy frames, so
        # its absolute bound is 1e-4 of the largest score, as K2's
        acc_g, acc_r = got[0] > 0, ref[0] > 0
        n_cand = max(int((acc_g | acc_r).sum()), 1)
        flips = int((acc_g != acc_r).sum())
        if flips > 1e-4 * n_cand:
            raise AssertionError(f"refine: {flips} of {n_cand} slots "
                                 "accepted by one version only")
        both = acc_g & acc_r
        err = _close(name, got[0][both], ref[0][both], 1e-5, 1e-4)
        s_ref = ref[1][both]
        s_err = _close(name + " score", got[1][both], s_ref, 1e-4,
                       1e-4 * s_ref.abs().max().item())
        return err, (f"refined rtol 1e-5/atol 1e-4 Hz; score rtol 1e-4/"
                     f"atol 1e-4*max (max abs err {s_err:.3e}); {flips} "
                     f"of {n_cand} gate flips (<= 1e-4)")
    raise KeyError(name)


def smooth_conv1d(ps, width, fs: int, fft_size: int, max_width_hz: float):
    """The box smoothing as one PyTorch call on inputs built beforehand: a
    depthwise F.conv1d of the mirror-extended rows with one (2K+1)-tap
    filter per frame (groups = N); returns the call."""
    import torch.nn.functional as F
    from tpuvc_torch.ops.smooth import box_weights, mirror_extend, n_taps_half
    ext = mirror_extend(ps, n_taps_half(fs, fft_size, max_width_hz))[None]
    wgt = box_weights(width, fs, fft_size, max_width_hz)[:, None, :]
    return lambda: F.conv1d(ext, wgt, groups=ps.shape[0])


def ladder_route(pairs):
    """The block scans as the JAX package runs them by default: the
    cummax/cummin ladders per event type."""
    from tpuvc_torch.ops.events import top2_max_scan, top2_min_scan_rev
    out = []
    for t in range(4):
        out += [*top2_max_scan(pairs[:, 4 * t], pairs[:, 4 * t + 1]),
                *top2_min_scan_rev(pairs[:, 4 * t + 2], pairs[:, 4 * t + 3])]
    return out


def conv1d_f32(tf32: bool):
    """The layer's convolution alone as one F.conv1d in float32 (the SAME
    padding and the channels-first layouts built beforehand), with cuDNN's
    TF32 (its tensor-core route) on or off during the call; returns a
    maker that takes the site's arguments and returns the call."""
    def make(x, w, b, gamma, beta, stride, slope):
        import torch.nn.functional as F
        from tpuvc_torch.ops.conv import same_pad
        xc = F.pad(x.float().transpose(1, 2),
                   same_pad(x.shape[1], w.shape[0], stride)).contiguous()
        wc = w.float().permute(2, 1, 0).contiguous()
        bf = b.float()

        def run():
            with cudnn_tf32(tf32):
                return F.conv1d(xc, wc, bf, stride=stride)
        return run
    return make


def ln_chain(h, gamma, beta, slope):
    """F.layer_norm and F.leaky_relu in h's dtype: what the model ran at a
    K11 site before K11."""
    import torch.nn.functional as F
    from tpuvc_torch.ops.conv import LN_EPS
    return F.leaky_relu(F.layer_norm(h, h.shape[-1:], gamma.to(h.dtype),
                                     beta.to(h.dtype), LN_EPS), slope)


# K11's sites in one default model call, in the order the model runs them
NORM_SITES = (*[f"encoder layer {i + 1}" for i in range(5)], "dense_norm",
              *[f"decoder step {i + 1}" for i in range(4)])


def d2s_chain(x, gamma, beta, s, slope):
    """Depth-to-space, then F.layer_norm and F.leaky_relu in x's dtype:
    what the default decoder runs at a subpixel site."""
    import torch.nn.functional as F
    from tpuvc_torch.ops.conv import LN_EPS
    n, length, cs = x.shape
    h = x.reshape(n, length * s, cs // s)
    return F.leaky_relu(F.layer_norm(h, h.shape[-1:], gamma.to(x.dtype),
                                     beta.to(x.dtype), LN_EPS), slope)


def phase_kernels(dev, state, dur_s: float = 4.0,
                  batches: dict | None = None,
                  two_pass_batch: int = 16) -> dict:
    """Each kernel against its plain version on the inputs the analysis
    and the fused model gave its wrapper: kernel name -> list of sites
    (the first is the one the JSON record reports, or all of them summed
    for the fused layers).  K3 also on the frames of ``two_pass_batch``
    utterances around TWO_PASS_F0, whose supports take its second pass."""
    import torch
    import torch.nn.functional as F
    from tpuvc_torch.ops import (contour, conv, d2s, events, harmonics,
                                 merge, norm, smooth, topk, window)
    batches = batches or {p: PATHS[p][1]
                          for p in ("default", "harvest", "harvest_decim2")}
    calls, sp = capture_inputs(dev, dur_s, batches)
    d, h, h2 = (calls[p] for p in ("default", "harvest", "harvest_decim2"))
    two_pass = capture_two_pass(dev, dur_s, two_pass_batch)
    m = capture_model_inputs(state, sp, dev)
    default = path_model("default", state, dev).encoder.stack
    fns = {"events": (events.event_block_pairs,
                      events.event_block_pairs_plain),
           "harmonics": (harmonics.harmonic_dft,
                         harmonics.harmonic_dft_plain),
           "window": (window.windowed_frames, window.windowed_frames_plain),
           "smooth": (smooth.box_smooth, smooth.box_smooth_plain),
           "topk": (topk.topk_sum, topk.topk_sum_plain),
           "refine": (harmonics.refine_score, harmonics.refine_score_plain),
           "scan": (events.top2_block_scans, events.top2_block_scans_plain),
           "conv": (conv.conv_ln_lrelu, conv.conv_ln_lrelu_plain),
           "d2s": (d2s.d2s_ln_lrelu, d2s.d2s_ln_lrelu_plain),
           "extend": (contour.extend_scans, contour.extend_scans_plain),
           "norm": (norm.norm_lrelu, norm.norm_lrelu_plain),
           "merge": (merge.merge_channels, merge.merge_channels_plain)}
    def default_layer(i):
        """Encoder layer i as the default architecture runs it (bf16
        compute: cuDNN conv, LayerNorm, LeakyReLU)."""
        c, nrm = default.convs[i], default.norms[i]
        return lambda x, *_: F.leaky_relu(nrm(c(x.to(torch.bfloat16))),
                                          default.slope)

    # one PyTorch call, or a chain of them labelled so, computing the
    # same function; for conv and d2s the default architecture's route.
    # Each entry takes the site's arguments and returns the call to time
    # (smooth builds its extended rows and weights before the timing)
    def call(fn):
        return lambda *a: (lambda: fn(*a))

    library = {"topk": call(lambda ps, kk: torch.topk(ps, kk).values.sum(-1)),
               "scan": call(ladder_route), "d2s": call(d2s_chain),
               "norm": call(ln_chain),
               "smooth": smooth_conv1d,
               **{f"conv{i}": call(default_layer(i)) for i in range(5)}}
    library_label = {
        "topk": "torch.topk(ps, kk).values.sum(-1)",
        "smooth": "F.conv1d(ext[None], wgt[:, None, :], groups=N), float32 "
                  "with TF32 off (depthwise, the mirror-extended rows and "
                  "per-frame weights built beforehand)",
        "scan": "ladder route: cummax/cummin per event type (the JAX "
                "default)",
        "conv": "chain cuDNN conv1d + LayerNorm + LeakyReLU in bfloat16 "
                "(the default encoder's layer)",
        "d2s": "chain view + F.layer_norm + F.leaky_relu in bfloat16 (the "
               "default decoder's)",
        "norm": "chain F.layer_norm + F.leaky_relu in the site's dtype (the "
                "model's two calls before K11)"}
    # further one-call yardsticks, each timed beside library_ms
    yardsticks = {"conv": {"library_f32_ms": conv1d_f32(False),
                           "library_tf32_ms": conv1d_f32(True)}}

    sites = [  # kernel, label, captured call[, library key]
        ("events", "DIO stride 20", d["events"][0]),
        ("events", "Harvest stride 8", h["events"][0]),
        ("events", "Harvest decim 2 stride 8", h2["events"][0]),
        ("harmonics", "StoneMask pass 1", d["harmonics"][0]),
        ("window", "CheapTrick", d["window"][0]),
        ("window", "CheapTrick, two-pass support", two_pass),
        ("smooth", "CheapTrick 2f0/3, 810 Hz cap", d["smooth"][0]),
        ("smooth", "D4C f0, 1056 Hz cap", d["smooth"][1]),
        ("smooth", "D4C f0/2 signed, 810 Hz cap", d["smooth"][2]),
        ("topk", "D4C band statistic", d["topk"][0]),
        ("refine", "Harvest refinement", h["refine"][0]),
        ("refine", "Harvest decim 2 refinement", h2["refine"][0]),
        ("scan", "DIO block scans", d["scan"][0]),
        ("scan", "Harvest block scans", h["scan"][0]),
        ("scan", "Harvest decim 2 block scans", h2["scan"][0]),
        *[("conv", f"encoder layer {i + 1}", c, f"conv{i}") for i, c in
          enumerate(m["conv"])],
        *[("d2s", f"decoder site {i + 1}", c) for i, c in
          enumerate(m["d2s"])],
        ("extend", "DIO contour, both passes", d["extend"][0]),
        ("extend", "Harvest contour, both passes", h["extend"][0]),
        ("merge", "Harvest channel merge", h["merge"][0]),
        ("merge", "Harvest decim 2 channel merge", h2["merge"][0]),
    ]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    res: dict = {}

    def measure(name, label, args, kwargs, *key):
        kern, plain = fns[name]
        got = kern(*args, **kwargs)
        ref = plain(*args, **kwargs)
        sync()
        err, tol = compare(name, got, ref)
        lib = library.get(key[0] if key else name)
        r = dict(site=label, shape=[list(a.shape) for a in args
                                    if hasattr(a, "shape")],
                 max_abs_err=err, tol=tol,
                 ms=cuda_ms(lambda: kern(*args, **kwargs)),
                 b2b_ms=cuda_ms(back_to_back(
                     lambda: kern(*args, **kwargs))) / B2B_REPS,
                 plain_ms=cuda_ms(lambda: plain(*args, **kwargs)),
                 library_ms=cuda_ms(lib(*args)) if lib else None,
                 library=library_label.get(name),
                 **{k: cuda_ms(make(*args))
                    for k, make in yardsticks.get(name, {}).items()},
                 **bound_of(name, args, got))
        del got, ref
        res.setdefault(name, []).append(r)
        say(f"[3 kernels] {name} ({label}): shapes {r['shape']} max_abs_err "
            f"{err:.3e} ({tol}); kernel {r['ms']:.4f} ms (back to back "
            f"{r['b2b_ms']:.4f} ms, mean of {B2B_REPS}), plain "
            f"{r['plain_ms']:.4f} ms, bound "
            + (f"{r['bound_ms']:.4f} ms " if r["bound_ms"] is not None
               else "")
            + f"({r['bound_by']}"
            + "".join(f"; {k} {r[k]:.4f}" for k in (
                "bound_full_row_ms", "bound_all_lanes_ms", "fp32_ops_ms",
                "throughput_bound_ms") if k in r)
            + (f"; {r['two_pass_frames']} of {r['shape'][0][0]} frames "
               "two-pass" if "two_pass_frames" in r else "")
            + (f"; {r['dependent_steps']} dependent steps, "
               f"{1e6 * r['ms'] / r['dependent_steps']:.1f} ns each"
               if "dependent_steps" in r else "") + "), library "
            + (f"{r['library_ms']:.4f} ms ({r['library']})" if lib
               else "none")
            + "".join(f"; {k} {r[k]:.4f}" for k in yardsticks.get(name, {})))
    for name, label, (args, kwargs), *key in sites:
        measure(name, label, args, kwargs, *key)
    del sites, calls, d, h, h2, m, default, two_pass
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # K11's sites last, with the other captures freed: the default model's
    # ten LayerNorm inputs at the default batch hold ~11 GB in bf16
    for label, (args, kwargs) in zip(NORM_SITES,
                                     capture_norm_inputs(state, sp, dev)):
        measure("norm", label, args, kwargs)
    del sp, args, kwargs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


# --- phase 12: vocoder -----------------------------------------------------

# the PWG cell's call: 64 rows of 6 s at 16 kHz; the stacks' first and last
# dilation
VOCODER_ROWS, VOCODER_SAMPLES = 64, 96000
VOCODER_DILATIONS = (1, 512)


def vocoder_state(spec, seed: int = 0) -> dict:
    """Seeded float32 weights for ``spec``'s generator: LeCun-normal
    kernels and biases of a tenth, so that every bias counts."""
    import torch
    from tpuvc_torch.models import pwg
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in pwg.ParallelWaveGAN(spec).state_dict().items():
        if k in ("aux_mean", "aux_scale"):
            out[k] = v
        elif v.dim() == 1:
            out[k] = 0.1 * torch.randn(v.shape, generator=g)
        else:
            out[k] = torch.randn(v.shape, generator=g) / math.sqrt(
                v[0].numel())
    return out


def pwg_against_plain(got, want, got_skip, want_skip, ops) -> tuple:
    """K13's next x and skip sum against the plain version's: each within
    one bf16 step of the plain value plus one bf16 step of every g carried
    through W2 (K13's tanh and its sum order may round a g the other way),
    and most values within one step alone.  Returns the max abs error and
    the share of values within one step."""
    import torch
    w2 = ops.w2.float().abs().sum(1) * 2.0 ** -8
    carry = {"x": w2[w2.shape[0] // 2:] * math.sqrt(0.5),
             "skip": w2[:w2.shape[0] // 2]}
    worst, within = 0.0, 1.0
    for name, g, w in (("x", got.reshape(-1, got.shape[-1]),
                        want.reshape(-1, want.shape[-1])),
                       ("skip", got_skip, want_skip)):
        err = (g.float() - w.float()).abs()
        e = torch.floor(torch.log2(w.abs().float().clamp(min=2.0 ** -126)))
        step = torch.exp2(e - 7.0)
        share = float((err <= step).float().mean())
        if (not bool(torch.isfinite(g.float()).all())
                or bool((err > step + carry[name]).any()) or share < 0.99):
            raise AssertionError(
                f"pwg: K13's {name} disagrees with its plain version (max "
                f"abs err {float(err.max()):.3e}, {100 * share:.3f}% within "
                "one bf16 step)")
        worst, within = max(worst, float(err.max())), min(within, share)
    return worst, within


@contextlib.contextmanager
def eager_layers(vocoder):
    """Every residual layer of ``vocoder`` on PyTorch's launches
    (``_ResidualBlock.eager``, the route before K13) inside the block."""
    for block in vocoder.conv_layers:
        block.forward = (lambda x, c, skip, out=None, b=block:
                         b.eager(x, c, skip))
    try:
        yield
    finally:
        for block in vocoder.conv_layers:
            del block.forward


def phase_vocoder(dev, rows: int = VOCODER_ROWS,
                  samples: int = VOCODER_SAMPLES,
                  profile_dir: str | None = None) -> dict:
    """K13 against its plain version on one layer's bf16 rows at the PWG
    cell's call (the next x and the skip sum, at dilations 1 and 512), and
    timed: a single call, back to back, the plain version and the layer as
    PyTorch's launches (the eager route the port took before K13, the
    yardstick), beside its bytes bound.  Then whole vocoder calls at the
    same size: a bf16 generator launches K13 once a layer (30), a float32
    one none; the K13 and eager bf16 calls' times, each waveform's error
    energy against the float32 generator's, and, profiled on the card,
    K13's device time per launch in the call."""
    import torch
    from tpuvc_torch.models import pwg
    from tpuvc_torch.ops import _build
    from tpuvc_torch.ops import pwg as op
    spec = pwg.PWGSpec()
    state = vocoder_state(spec)
    half = pwg.load_vocoder(spec, state, dev, "bfloat16")
    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    x = torch.randn((rows, samples, spec.residual_channels), generator=g,
                    device=dev).to(bf)
    c = torch.randn((rows * samples, spec.aux_channels), generator=g,
                    device=dev).to(bf)
    skip = torch.randn((rows * samples, spec.skip_channels), generator=g,
                       device=dev).to(bf)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    per_stack = spec.layers // spec.stacks
    sites = []
    for d in VOCODER_DILATIONS:
        block = half.conv_layers[int(math.log2(d)) % per_stack]
        assert block.dilation == d
        ops = block.operands()
        got_skip, want_skip = skip.clone(), skip.clone()
        got = op.residual_layer(x, c, got_skip, ops, d)
        want = op.residual_layer_plain(x, c, want_skip, ops, d)
        sync()
        err, within = pwg_against_plain(got, want, got_skip, want_skip, ops)
        del want, want_skip
        out = torch.empty_like(x)
        r = dict(site=f"one layer at dilation {d}, {rows} x {samples}",
                 shape=[list(x.shape), list(c.shape), list(skip.shape)],
                 max_abs_err=err, within_one_step=within,
                 tol="one bf16 step + one bf16 step of g through W2; "
                     ">= 99% within one step",
                 ms=cuda_ms(lambda: op.residual_layer(x, c, got_skip, ops, d,
                                                      out)),
                 b2b_ms=cuda_ms(back_to_back(
                     lambda: op.residual_layer(x, c, got_skip, ops, d,
                                               out))) / B2B_REPS,
                 plain_ms=cuda_ms(lambda: op.residual_layer_plain(
                     x, c, got_skip, ops, d)),
                 library_ms=cuda_ms(lambda: block.eager(x, c, got_skip)),
                 library="the layer as PyTorch launches it in bf16: cuDNN's "
                         "NHWC dilated convolution, cuBLAS's products "
                         "adding into their destinations, ATen's gate",
                 **bound_of("pwg", (x, c, skip, ops, d), got))
        del got, got_skip, out
        sites.append(r)
        say(f"[12 vocoder] pwg ({r['site']}): max_abs_err {err:.3e}, "
            f"{100 * within:.4f}% within one bf16 step; kernel "
            f"{r['ms']:.4f} ms (back to back {r['b2b_ms']:.4f} ms, mean of "
            f"{B2B_REPS}), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; bytes "
            f"{r['bytes_ms']:.4f}, operations {r['ops_ms']:.4f}), library "
            f"{r['library_ms']:.4f} ms ({r['library']})")
    del x, c, skip
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # whole calls: the PWG cell's noise and conditioning shapes
    n = samples // spec.hop
    z = torch.randn((rows, n * spec.hop), generator=g, device=dev)
    cond = torch.randn((rows, spec.aux_channels, n), generator=g,
                       device=dev)
    full = pwg.load_vocoder(spec, state, dev, "float32")
    _build.reset_counts()
    want = full(z, cond)
    sync()
    f32_launches = _build.read_counts()["pwg"]
    if f32_launches:
        raise AssertionError(f"pwg: a float32 vocoder launched K13 "
                             f"{f32_launches} times")
    _build.reset_counts()
    y = half(z, cond)
    sync()
    launches = _build.read_counts()["pwg"]
    _build.require_launches(pwg.vocoder_kernels(half), dev, "vocoder")
    want_launches = spec.layers if pwg.vocoder_kernels(half) else 0
    if launches != want_launches:
        raise AssertionError(f"pwg: {launches} K13 launches in a vocoder "
                             f"call, not {want_launches}")

    def db(a):
        return float(10 * torch.log10(((a - want) ** 2).sum()
                                      / (want ** 2).sum()))
    # the same bf16 generator with every layer on PyTorch's launches
    with eager_layers(half):
        eager_y = half(z, cond)
        eager_ms = cuda_ms(lambda: half(z, cond))
    rec = {"sites": sites, "launches_per_call": launches,
           "float32_launches_per_call": f32_launches,
           "call_ms": cuda_ms(lambda: half(z, cond)),
           "call_eager_ms": eager_ms,
           "wave_err_db_vs_float32": db(y),
           "wave_err_db_vs_float32_eager": db(eager_y),
           "call_shape": [list(z.shape), list(cond.shape)],
           "in_call_ms": None}
    if rec["wave_err_db_vs_float32"] > -25.0:
        raise AssertionError(f"pwg: the bf16 vocoder reads "
                             f"{rec['wave_err_db_vs_float32']:.2f} dB "
                             "against the float32 one")
    if dev.type == "cuda":
        prof = profile_call(lambda: half(z, cond),
                            profile_dir or os.path.join(ROOT, "build"),
                            "vocoder_profile.txt", phase="12 vocoder")
        k = prof.get("port_kernels", {}).get("pwg_residual_kernel")
        if k:
            rec["in_call_ms"] = k["device_ms"] / k["launches"]
            rec["in_call_launches"] = k["launches"]
        rec["call_profile"] = prof
    say(f"[12 vocoder] a bf16 vocoder call of {rows} x {n * spec.hop}: "
        f"{launches} K13 launches (float32: {f32_launches}), "
        f"{rec['call_ms']:.2f} ms (every layer eager: "
        f"{rec['call_eager_ms']:.2f} ms); K13 in the call "
        + (f"{rec['in_call_ms']:.4f} ms a launch"
           if rec["in_call_ms"] is not None else "not measured")
        + f"; against the float32 generator {rec['wave_err_db_vs_float32']:.2f}"
        f" dB (eager bf16 {rec['wave_err_db_vs_float32_eager']:.2f} dB)")
    return rec


# --- phase 4: serve ------------------------------------------------------

def build_state():
    """Seeded random float32 parameters (on the CPU) of the full-width
    VAW-GAN; both architectures take the same state dict."""
    import torch
    from tpuvc_torch.models.params import init_params
    from tpuvc_torch.utils.config import Architecture
    return init_params(Architecture(), torch.Generator().manual_seed(0),
                       device="cpu")


def phase_serve(path: str, dev, state,
                durs=(1.0, 1.7, 2.3, 3.1, 3.6, 4.0)):
    """Requests of ``durs`` seconds through the path's Converter (its
    architecture in bf16 compute) with the launch counters zeroed just
    before and read just after; on the default path the same requests
    through float32 and pcm12 transfer; then card vs CPU.  Returns
    (converter, launches, card-vs-CPU SNR, transfer SNRs), the SNRs None
    where the path skips them."""
    import torch
    from tpuvc_torch.convert.pipeline import (Converter,
                                              make_batch_convert_fn,
                                              synthesis_noise)
    from tpuvc_torch.models import pwg, vae
    from tpuvc_torch.ops._build import (read_counts, require_launches,
                                        reset_counts)
    cfg = path_cfg(path)
    model = path_model(path, state, dev)
    rng = np.random.default_rng(0)
    src = [0, 1, 2, 3, 4, 5][:len(durs)]
    trg = [5, 3, 7, 0, 9, 2][:len(durs)]
    xs = [utterance(rng, s, d) for s, d in zip(src, durs)]
    assets = make_assets(xs, src, cfg, dev)
    vstate = path_vocoder_state(path, xs, cfg, dev)
    vocoder = (None if vstate is None else
               pwg.load_vocoder(pwg.PWGSpec(), vstate, dev, "bfloat16"))
    conv = Converter(model, assets, cfg, transfer_encoding="ulaw8",
                     device=dev, vocoder=vocoder)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    reset_counts()
    decodes: list = []
    nhwc: list = []
    vocodes: list = []
    t0 = time.perf_counter()
    with spy(model, "decode", decodes), spy(vae.Conv, "_nhwc", nhwc), (
            spy(vocoder, "forward", vocodes) if vocoder is not None
            else contextlib.nullcontext()):
        ys = conv.convert_batch(xs, [SPEAKERS[i] for i in src],
                                [SPEAKERS[i] for i in trg], seed=0)
    sync()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_nhwc, n_vocodes = len(nhwc), len(vocodes)
    del nhwc, vocodes           # the spies held the activations
    if not decodes or n_nhwc != serving_convs(path) * len(decodes):
        raise AssertionError(f"{path}: {n_nhwc} channels-last "
                             f"convolutions over {len(decodes)} model calls,"
                             f" where {serving_convs(path)} a call are "
                             "expected")
    for x, y in zip(xs, ys):
        rms_db = 10 * math.log10(float(np.mean(y.astype(np.float64) ** 2))
                                 + 1e-30)
        if y.shape != x.shape or not np.all(np.isfinite(y)):
            raise AssertionError(f"{path}: output shape {y.shape} vs input "
                                 f"{x.shape}, or non-finite")
        if not (-50.0 < rms_db < -3.0 and np.max(np.abs(y)) <= 1.0):
            raise AssertionError(f"{path}: output level {rms_db:.1f} dBFS "
                                 "is not speech scale")
    if vocoder is not None and not n_vocodes:
        raise AssertionError(f"{path}: the converter never called its "
                             "vocoder")
    vocoded = pwg.vocoder_kernels(vocoder) if vocoder is not None else ()
    require_launches(path_kernels(path) + vocoded, dev, f"{path} path")
    # K13 once a residual layer of every vocoder call, and nowhere else
    want_pwg = pwg.PWGSpec().layers * n_vocodes if vocoded else 0
    if dev.type == "cuda" and launches["pwg"] != want_pwg:
        raise AssertionError(f"{path}: {launches['pwg']} K13 launches over "
                             f"{n_vocodes} vocoder calls, not {want_pwg}")
    say(f"[4 serve] {path}: {len(xs)} requests ({sum(durs):.1f} s of audio,"
        f" {', '.join(f'{d:g}' for d in durs)} s) converted in {wall:.3f} s;"
        f" kernel launches {launches}; {n_nhwc} channels-last "
        f"convolutions over {len(decodes)} model calls"
        + (f", {n_vocodes} vocoder calls" if vocoder is not None else "")
        + "; output RMS "
        + ", ".join(f"{10 * math.log10(float(np.mean(y ** 2))):.1f}"
                    for y in ys) + " dBFS")
    transfer = None
    if path == "default":
        # the same requests, seed and model through the two other transfer
        # encodings: ulaw8 and pcm12 decoded on the host against float32
        # clipped to the codes' range [-1, 1], as int16 codes would be
        f32, p12 = (Converter(model, assets, cfg, transfer_encoding=enc,
                              device=dev).convert_batch(
                        xs, [SPEAKERS[i] for i in src],
                        [SPEAKERS[i] for i in trg], seed=0)
                    for enc in ("float32", "pcm12"))
        refs = [np.clip(y, -1.0, 1.0) for y in f32]
        transfer = {"ulaw8": min_snr_db(refs, ys),
                    "pcm12": min_snr_db(refs, p12)}
        say(f"[4 serve] {path}: transfer SNR against clipped float32, min "
            f"over the requests: ulaw8 {transfer['ulaw8']:.1f} dB (floor 30), "
            f"pcm12 {transfer['pcm12']:.1f} dB (floor 50)")
        if not (transfer["ulaw8"] >= 30.0 and transfer["pcm12"] >= 50.0):
            raise AssertionError(f"{path}: transfer SNRs {transfer} under "
                                 "their floors")
    snr = None
    if path != "nccf":
        # the card against the CPU on a small input: same params in
        # float32, same noise; the CPU runs every kernel's plain version
        x1 = torch.tensor(xs[1][:FS])[None]
        n_samples = (x1.shape[1] // cfg.hop + 1) * cfg.hop
        noise = synthesis_noise([11], n_samples, "cpu")
        a = assets
        outs = []
        for d in (dev.type, "cpu"):
            t = lambda v: torch.tensor(v, device=d)  # noqa: E731
            fn = make_batch_convert_fn(
                path_model(path, state, d, "float32"), cfg,
                vocoder=None if vstate is None else pwg.load_vocoder(
                    pwg.PWGSpec(), vstate, d, "float32"))
            outs.append(fn(x1.to(d), t([3]), t(a.xmin), t(a.xmax),
                           t(a.f0_mu[[1]]), t(a.f0_sigma[[1]]),
                           t(a.f0_mu[[3]]), t(a.f0_sigma[[3]]),
                           noise.to(d)).cpu().numpy()[0])
        y_gpu, y_cpu = outs
        snr = 10 * math.log10(np.sum(y_cpu.astype(np.float64) ** 2)
                              / max(np.sum((y_gpu - y_cpu).astype(np.float64)
                                           ** 2), 1e-30))
        say(f"[4 serve] {path}: card vs CPU on a {x1.shape[1] / FS:g} s "
            f"input (float32 model): waveform SNR {snr:.1f} dB (bound "
            "30 dB)")
        if not snr >= 30.0:
            raise AssertionError(f"{path}: card and CPU disagree: SNR "
                                 f"{snr:.1f} dB")
    return conv, launches, snr, transfer


def phase_entry_points(conv, dev) -> dict:
    """The fused path's other entry points, launch counters zeroed just
    before and read just after each: one 3 s request streamed in 0.25 s
    blocks through StreamingConverter, and the analysis CLI over a
    synthetic corpus of 2 speakers x 2 utterances of 1.5 s."""
    import torch
    from tpuvc_torch.cli import analyze
    from tpuvc_torch.convert.streaming import StreamingConverter
    from tpuvc_torch.io import corpus, records
    from tpuvc_torch.io.wav import write_wav
    from tpuvc_torch.ops._build import read_counts, reset_counts
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(3)
    x = utterance(rng, 2, 3.0)
    sync()
    reset_counts()
    t0 = time.perf_counter()
    st = StreamingConverter(conv, SPEAKERS[2], SPEAKERS[7], chunk_s=1.0,
                            cfg=conv.cfg)
    y = np.concatenate([st.push(x[i:i + FS // 4])
                        for i in range(0, len(x), FS // 4)] + [st.flush()])
    sync()
    wall = time.perf_counter() - t0
    stream_launches = read_counts()
    missing = unlaunched(stream_launches, "fused")
    if abs(len(y) - len(x)) > st.halo + conv.cfg.hop or not (
            np.all(np.isfinite(y)) and np.std(y) > 1e-4):
        raise AssertionError(f"streaming: {len(y)} samples for {len(x)}, "
                             "or non-finite or silent")
    if missing and cuda:
        raise AssertionError(f"streaming did not launch: {missing}")
    say(f"[4 serve] fused: StreamingConverter, {len(x) / FS:g} s in "
        f"{FS // 4}-sample blocks -> {len(y)} samples in {wall:.3f} s "
        f"(chunk {st.chunk}, halo {st.halo}); kernel launches "
        f"{stream_launches}")

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as root:
        for spk in range(2):
            for u in range(2):
                write_wav(os.path.join(root, "wav", corpus.TRAIN_SPLIT,
                                       SPEAKERS[spk], f"u{u}.wav"),
                          utterance(rng, spk, 1.5), FS)
        sync()
        reset_counts()
        t0 = time.perf_counter()
        analyze.main(["--corpus", root, "--bucket-s", "1.0", "--quiet",
                      "--device", dev.type])
        sync()
        wall_cli = time.perf_counter() - t0
        cli_launches = read_counts()
        bins = corpus.list_bins(root, corpus.TRAIN_SPLIT)
        feats = [records.read_bin(b) for b in bins]
        etc = os.path.join(root, "etc")
        stats = (*corpus.load_norm_stats(etc), *corpus.load_f0_stats(etc))
    n_frames = 1.5 * FS // conv.cfg.hop + 1
    if len(bins) != 4 or any(
            f.sp.shape != (n_frames, 513) or not all(
                np.all(np.isfinite(getattr(f, k))) for k in ("sp", "ap",
                                                             "f0", "en"))
            for f in feats) or not all(np.all(np.isfinite(v))
                                       for v in stats):
        raise AssertionError("cli.analyze: records or etc/ stats missing "
                             "or not finite")
    missing = unlaunched(cli_launches, model=False)
    if missing and cuda:
        raise AssertionError(f"cli.analyze did not launch: {missing}")
    say(f"[4 serve] fused: python -m tpuvc_torch.cli.analyze over 2 speakers"
        f" x 2 utterances of 1.5 s in {wall_cli:.3f} s: {len(bins)} records "
        f"of {n_frames:g} frames, etc/ stats finite (f0 means "
        f"{np.round(stats[2], 4).tolist()}); kernel launches {cli_launches}")
    return {"stream_s": wall, "stream_launches": stream_launches,
            "analyze_s": wall_cli, "analyze_launches": cli_launches}


# --- phase 5: rate -------------------------------------------------------

def phase_rate(path: str, conv, card: str, dev, batch: int,
               dur_s: float = 4.0, profile_dir: str | None = None,
               budget_batch: int | None = None) -> dict:
    import torch
    from tpuvc_torch.convert import pipeline
    from tpuvc_torch.dsp import d4c, dio, harvest, stonemask
    from tpuvc_torch.dsp.cheaptrick import cheaptrick
    from tpuvc_torch.models import pwg
    cfg = conv.cfg
    rng = np.random.default_rng(1)
    xs, src = batch_of(rng, batch, dur_s)
    trg = [(i * 7 + 3) % 10 for i in range(batch)]
    names = lambda ids: [SPEAKERS[i] for i in ids]  # noqa: E731
    call = lambda: conv.convert_batch(  # noqa: E731
        xs, names(src), names(trg), seed=0)
    call()                                                   # warm-up
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        lat.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    best = min(lat)
    say(f"[5 rate] {path}: batch {batch} x {dur_s:g} s, ulaw8: "
        f"{batch * dur_s / best:.2f} audio s per wall s (best of 3 calls; "
        f"latencies {', '.join(f'{v:.4f}' for v in lat)} s); peak device "
        f"memory {peak:.2f} GiB; card {card}")
    prof = (profile_call(call, profile_dir, f"{path}_profile.txt")
            if profile_dir else None)

    # per-stage device time of the same batch (host clock around
    # synchronised stages)
    a = conv.assets
    x = torch.tensor(np.stack(xs), device=dev)
    stages = {}

    def stage(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        stages[name] = time.perf_counter() - t0
        return out

    with torch.no_grad():
        if cfg.f0_method == "harvest":
            f0 = stage("harvest", lambda: harvest.harvest(x))
        else:
            f0c = stage("dio", lambda: dio.dio(x))
            f0 = stage("stonemask", lambda: stonemask.stonemask(x, f0c))
        sp = stage("cheaptrick", lambda: cheaptrick(x, f0))
        ap = stage(f"d4c_{cfg.ap_method}",
                   lambda: d4c.d4c(x, f0, method=cfg.ap_method))
        xmin = torch.tensor(a.xmin, device=dev)
        xmax = torch.tensor(a.xmax, device=dev)
        n = f0.shape[1]

        def model():
            u, en = pipeline._normalize_sp(sp, xmin, xmax)
            z, _ = conv.model.encode(u.reshape(batch * n, -1))
            y = torch.tensor(trg, device=dev).repeat_interleave(n)
            return pipeline._denormalize_sp(
                conv.model.decode(z, y).reshape(batch, n, -1), en, xmin,
                xmax)

        sp_c = stage("model", model)
        noise = stage("noise", lambda: pipeline.synthesis_noise(
            range(batch), n * cfg.hop, dev))
        voc = conv.vocoder
        if voc is not None:
            y = stage("vocode", lambda: voc(noise, pwg.aux_features(
                f0, sp_c, ap, cfg, voc.spec)))
        else:
            y = stage("synthesis", lambda: pipeline.synthesize(
                f0, sp_c, ap, noise))
        stage("ulaw8+d2h", lambda: conv._encode_transfer(y).cpu())
    say(f"[5 rate] {path}: stages (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    out = {"batch": batch, "audio_s_per_s": batch * dur_s / best,
           "latency_s": lat, "peak_gib": peak, "stages_s": stages,
           "profile": prof}
    if budget_batch:
        # one call at the Converter's per-call budget: does it fit?
        xs_b, src_b = batch_of(rng, budget_batch, dur_s)
        sync()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        conv.convert_batch(xs_b, names(src_b), names(src_b[::-1]), seed=0)
        sync()
        wall = time.perf_counter() - t0
        peak_b = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
        out["budget"] = {"batch": budget_batch, "wall_s": wall,
                         "peak_gib": peak_b}
        say(f"[5 rate] {path}: one call of {budget_batch} x {dur_s:g} s "
            f"({budget_batch * dur_s:g} s, MAX_AUDIO_S_PER_CALL "
            f"{conv.MAX_AUDIO_S_PER_CALL:g}) in {wall:.4f} s; peak device "
            f"memory {peak_b:.2f} GiB")
    return out


# --- phase 6: train -------------------------------------------------------

TRAIN_ARCH = "configs/architecture-vawgan-vcc2016.json"


# the card-vs-CPU step: the loss dict within STEP_RTOL (+ STEP_ATOL), the
# parameters under params_agree's rule with these
STEP_RTOL, STEP_ATOL = 1e-3, 1e-5
PARAM_FRAC, PARAM_TOL = 1e-2, 1e-2


def params_agree(got: dict, ref: dict, grads: dict, lr: float,
                 frac: float, tol: float) -> dict:
    """The parameter rule for two runs of the same Adam updates: Adam's
    first update is about lr sign(g), so an element whose gradient is near
    0 turns on rounding and may move 2 lr the other way.  Elements whose
    |g| in every update (``grads[name]``, one tensor per update) is at
    least ``frac`` of its tensor's max |g| must agree within tol lr + 1e-6
    |p|; every other element within 2 lr per update.  Raises on a breach;
    returns the largest errors of both kinds in units of lr."""
    import torch
    worst = {"significant": 0.0, "rest": 0.0}
    for n, g in got.items():
        g = g.detach().cpu()
        r = ref[n].detach().cpu()
        sig = torch.ones_like(g, dtype=torch.bool)
        for u in grads[n]:
            u = u.cpu().abs()
            sig &= u >= frac * u.max()
        err = (g - r).abs()
        if bool((err[sig] > tol * lr + 1e-6 * r[sig].abs()).any()) or bool(
                (err > 2 * lr * len(grads[n]) + 1e-6).any()):
            raise AssertionError(f"{n}: parameters disagree (max err "
                                 f"{err.max().item() / lr:.3e} lr)")
        for k, m in (("significant", sig), ("rest", ~sig)):
            if bool(m.any()):
                worst[k] = max(worst[k], err[m].max().item() / lr)
    return worst


def record_grads(opt) -> list:
    """Every update's gradients of ``opt``'s parameters, in order."""
    seen = []
    opt.register_step_pre_hook(lambda o, *_: seen.append(
        [p.grad.detach().clone() for g in o.param_groups
         for p in g["params"]]))
    return seen


def named_grads(module, seen) -> dict:
    return {n: [u[i] for u in seen]
            for i, (n, _) in enumerate(module.named_parameters())}


def step_ms(fn, dev, n: int) -> float:
    """Host clock around ``n`` synchronised calls after one warm-up, per
    call in ms."""
    import torch
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / n


@contextlib.contextmanager
def cudnn_tf32(on: bool):
    """cuDNN's TF32 (its tensor-core route for float32 convolutions) on or
    off inside the block."""
    import torch
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def phase_train(dev, tmp: str, arch_path: str = TRAIN_ARCH,
                n_speakers: int = 10, n_utts: int = 8, n_test: int = 2,
                dur_s: float = 1.5, steps: int = 20,
                resident: int = 10, vae_steps: int = 200,
                step_batch: int | None = None,
                profile_dir: str | None = None) -> dict:
    """Training through the port's entry points, on ``dev``, in the
    directory ``tmp``: make_vcc2016_corpus's synthetic corpus (its first
    ``n_speakers`` speakers, ``n_utts`` training and ``n_test`` test
    utterances of ``dur_s`` s each, the test ones parallel across
    speakers), its
    training split analysed by cli.analyze; cli.train for ``steps``
    streaming steps, then resumed with ``--restore_from`` on the resident
    path (``--resident``) to 2 x ``steps``; one VAW-GAN step on the card and on the CPU from the
    same seeded parameters, batch and noise; a VAE resident run of
    ``vae_steps`` whose loss must fall; and the steps' times.  The record
    names the run directory and the corpus (``run_dir``, ``corpus``)."""
    import dataclasses
    import torch
    from tpuvc_torch.cli import analyze
    from tpuvc_torch.cli import train as cli_train
    from tpuvc_torch.data import synthetic
    from tpuvc_torch.data.dataset import FrameDataset
    from tpuvc_torch.data.normalizer import Tanhize
    from tpuvc_torch.io import corpus as corpus_io
    from tpuvc_torch.models import vae as vae_model
    from tpuvc_torch.ops._build import read_counts, reset_counts
    from tpuvc_torch.train import steps as steps_lib
    from tpuvc_torch.train import trainer as trainer_lib
    from tpuvc_torch.utils.config import Architecture
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_phase = time.perf_counter()
    arch = Architecture.load(os.path.join(ROOT, arch_path))
    rec: dict = {"architecture": arch_path}
    corpus = os.path.join(tmp, "corpus")
    defs = dict(list(synthetic.VCC2016_SPEAKER_DEFS.items())[:n_speakers])
    synthetic.make_corpus(corpus, n_train=n_utts, n_test=0, dur_s=dur_s,
                          seed=0, speaker_defs=defs)
    # the test split, parallel across speakers (conversion MCD compares a
    # conversion with the target's recording of the same utterance), comes
    # from a corpus of its own: the training split stays the non-parallel
    # one the card-vs-CPU step's parameter rule was set on.  On a parallel
    # training split one critic element misses that rule by 4% through
    # float32 conditioning that both devices show (PERF.md, section 6)
    parallel = os.path.join(tmp, "parallel")
    synthetic.make_corpus(parallel, n_train=0, n_test=n_test, dur_s=dur_s,
                          seed=0, speaker_defs=defs, parallel=True)
    test_dir = os.path.join("wav", corpus_io.TEST_SPLIT)
    shutil.rmtree(os.path.join(corpus, test_dir))
    os.replace(os.path.join(parallel, test_dir),
               os.path.join(corpus, test_dir))
    sync()
    reset_counts()
    t0 = time.perf_counter()
    analyze.main(["--corpus", corpus, "--splits", "train", "--quiet",
                  "--device", dev.type])
    sync()
    rec["analyze_s"] = time.perf_counter() - t0
    rec["analyze_launches"] = read_counts()
    missing = unlaunched(rec["analyze_launches"], model=False)
    if missing and cuda:
        raise AssertionError(f"train corpus: cli.analyze did not launch "
                             f"{missing}")
    ds = FrameDataset.from_bin_dir(corpus)
    say(f"[6 train] corpus: {n_speakers} speakers x {n_utts} training (+ "
        f"{n_test} test) utterances of {dur_s:g} s, {len(ds)} frames, analysed by cli.analyze in "
        f"{rec['analyze_s']:.3f} s; kernel launches "
        f"{rec['analyze_launches']}")

    # cli.train: streaming, then resumed on the resident path
    resumed = []
    real_resume = trainer_lib._BaseTrainer._resume

    def resume(self, *a, **kw):
        resumed.append(real_resume(self, *a, **kw))
        return resumed[-1]

    common = ["--architecture", os.path.join(ROOT, arch_path),
              "--corpus", corpus, "--logdir", os.path.join(tmp, "logs"),
              "--no-tensorboard", "--device", dev.type]
    trainer_lib._BaseTrainer._resume = resume
    try:
        sync()
        reset_counts()
        t0 = time.perf_counter()
        run = cli_train.main(common + ["--steps", str(steps)])
        sync()
        t1 = time.perf_counter()
        cli_train.main(common + ["--restore_from", run, "--steps",
                                 str(2 * steps), "--resident",
                                 str(resident)])
        sync()
        t2 = time.perf_counter()
    finally:
        trainer_lib._BaseTrainer._resume = real_resume
    rec["train_launches"] = read_counts()
    rec["cli_streaming_s"], rec["cli_resident_s"] = t1 - t0, t2 - t1
    ckpts = sorted(os.listdir(os.path.join(run, "ckpt")))
    with open(os.path.join(run, "events", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    rec.update(run_dir=run, corpus=corpus, resumed_at=resumed[-1],
               ckpts=ckpts,
               logged_steps=[r["step"] for r in logged],
               final_step=logged[-1]["step"],
               final_metrics={k: v for k, v in logged[-1].items()
                              if k not in ("step", "time")})
    finite = all(math.isfinite(v) for r in logged for k, v in r.items())
    if (resumed != [0, steps] or rec["final_step"] != 2 * steps
            or ckpts != [f"{steps}.pt", f"{2 * steps}.pt"] or not finite
            or not os.path.exists(os.path.join(run, "architecture.json"))):
        raise AssertionError(f"cli.train: resumed at {resumed}, logged "
                             f"{[r['step'] for r in logged]}, "
                             f"checkpoints {ckpts}, finite {finite}")
    if any(rec["train_launches"].values()):
        raise AssertionError("training launched a hand kernel: "
                             f"{rec['train_launches']}")
    say(f"[6 train] cli.train {arch.model}/{arch.trainer} ({arch_path}, "
        f"batch {arch.training.batch_size}, n_unroll "
        f"{arch.training.n_unroll}): {steps} streaming steps in "
        f"{rec['cli_streaming_s']:.3f} s, resumed at step "
        f"{resumed[-1]} and run to {rec['final_step']} with --resident "
        f"{resident} in {rec['cli_resident_s']:.3f} s (both with "
        f"start-up); checkpoints {ckpts}; metrics finite, last "
        + ", ".join(f"{k} {v:.4f}" for k, v in
                    rec["final_metrics"].items())
        + f"; kernel launches {rec['train_launches']}")

    # one VAW-GAN step on the card and on the CPU, same everything
    b = step_batch or arch.training.batch_size
    norm = Tanhize.from_etc(os.path.join(corpus, "etc"))
    stream = ds.batches(b, seed=0, normalizer=norm)
    xs, ys = zip(*(next(stream) for _ in range(arch.training.n_unroll
                                               + 1)))
    batch = (torch.from_numpy(np.stack(xs[:-1])),
             torch.from_numpy(np.stack(ys[:-1])).long(),
             torch.from_numpy(xs[-1]), torch.from_numpy(ys[-1]).long())
    noise = steps_lib.vawgan_noise(steps_lib.step_generator(0, 0, dev),
                                   b, arch)
    runs = {}
    nhwc: list = []
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        st = steps_lib.init_vawgan_state(arch, 0, d)
        seen_g, seen_d = record_grads(st.opt_g), record_grads(st.opt_d)
        with spy(vae_model.Conv, "_nhwc", nhwc):
            m = steps_lib.vawgan_step(
                st, *(v.to(d) for v in batch),
                steps_lib.VAWGANNoise(noise.z_crit.to(d), noise.gp.to(d),
                                      noise.z_gen.to(d)))
        runs[name] = dict(m={k: float(v) for k, v in m.items()},
                          gen=dict(st.gen.named_parameters()),
                          critic=dict(st.critic.named_parameters()),
                          grads_g=named_grads(st.gen, seen_g),
                          grads_d=named_grads(st.critic, seen_d))
    # training keeps the transposing convolutions (models/vae.py:Conv)
    rec["step_nhwc_convs"] = len(nhwc)
    if nhwc:
        raise AssertionError(f"the VAW-GAN steps ran {len(nhwc)} "
                             "convolutions channels-last")
    card, cpu = runs["card"], runs["cpu"]
    rel = {k: abs(card["m"][k] - cpu["m"][k]) / max(abs(cpu["m"][k]),
                                                    1e-30)
           for k in cpu["m"]}
    bad = [k for k in cpu["m"] if abs(card["m"][k] - cpu["m"][k])
           > STEP_RTOL * abs(cpu["m"][k]) + STEP_ATOL]
    if bad:
        raise AssertionError(f"VAW-GAN step, card vs CPU: {bad} differ "
                             f"({card['m']} vs {cpu['m']})")
    lr = arch.training.lr
    worst_g = params_agree(card["gen"], cpu["gen"], cpu["grads_g"], lr,
                           PARAM_FRAC, PARAM_TOL)
    worst_d = params_agree(card["critic"], cpu["critic"],
                           cpu["grads_d"], lr, PARAM_FRAC, PARAM_TOL)
    rec["card_vs_cpu"] = {"batch": b, "metrics_card": card["m"],
                          "metrics_cpu": cpu["m"],
                          "max_rel_err": max(rel.values()),
                          "gen_err_lr": worst_g,
                          "critic_err_lr": worst_d}
    say(f"[6 train] one full VAW-GAN step (batch {b}), card vs CPU from "
        f"the same seeded parameters, batch and noise: loss dict max "
        f"relative error {max(rel.values()):.3e} (bound rtol "
        f"{STEP_RTOL:g} + atol {STEP_ATOL:g}); parameters, in lr, "
        f"generator {worst_g['significant']:.3e} where |g| >= "
        f"{PARAM_FRAC:g} max (bound {PARAM_TOL:g}) / {worst_g['rest']:.3e}"
        f" elsewhere (bound 2 per update), critic "
        f"{worst_d['significant']:.3e} / {worst_d['rest']:.3e}")
    del runs, card, cpu, st

    # the VAE learns: a resident run whose logged loss falls
    vae_arch = dataclasses.replace(arch, model="VAE",
                                   trainer="VAETrainer")
    vae = trainer_lib.make_trainer(vae_arch, os.path.join(tmp, "vae"),
                                   use_tensorboard=False, device=dev)
    data = norm.forward(ds.x)
    n_inner = max(1, vae_steps // 20)
    vae.train_resident(data, ds.y, vae_steps, n_inner=n_inner,
                       log_every=n_inner, save_every=vae_steps)
    vae.close()
    with open(os.path.join(tmp, "vae", "events", "metrics.jsonl")) as f:
        loss = [json.loads(line)["loss"] for line in f]
    first, last = float(np.mean(loss[:5])), float(np.mean(loss[-5:]))
    rec["vae"] = {"steps": vae_steps, "loss": loss, "first": first,
                  "last": last}
    if not last < first:
        raise AssertionError(f"VAE loss did not fall: {loss}")
    say(f"[6 train] VAE resident run, {vae_steps} steps ({n_inner} per "
        f"call): mean loss of the first 5 log points {first:.4f}, of the"
        f" last 5 {last:.4f}")

    # informational times, with cuDNN's TF32 on (PyTorch's default,
    # what cli.train runs with) and off (float32 throughout, as the
    # comparisons run)
    st = steps_lib.init_vawgan_state(arch, 0, dev)
    xc, yc, xg, yg = (v.to(dev) for v in batch)
    table = torch.as_tensor(data, device=dev)
    labels = torch.as_tensor(ds.y, device=dev).long()
    calls = {
        "vawgan_step": (lambda: steps_lib.vawgan_step(
            st, xc, yc, xg, yg, noise), 1),
        "vawgan_resident_step": (lambda: steps_lib.vawgan_multistep(
            st, table, labels, 10, 0), 10),
        "vae_resident_step": (lambda: steps_lib.vae_multistep(
            vae.state, table, labels, 10, 0), 10)}
    times: dict = {}
    for tf32 in (True, False):
        tag = "tf32_on" if tf32 else "tf32_off"
        with cudnn_tf32(tf32):
            for name, (fn, per) in calls.items():
                if cuda:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                times.setdefault(name + "_ms", {})[tag] = step_ms(
                    fn, dev, 5 if per == 1 else 2) / per
                times.setdefault(name + "_peak_gib", {})[tag] = (
                    torch.cuda.max_memory_allocated() / 2 ** 30
                    if cuda else 0.0)
            if profile_dir and cuda:
                for name in ("vawgan_step", "vae_resident_step"):
                    fn = (calls[name][0] if name == "vawgan_step" else
                          lambda: steps_lib.vae_multistep(
                              vae.state, table, labels, 1, 0))
                    times.setdefault("profile", {})[
                        f"{name}_{tag}"] = profile_call(
                            fn, profile_dir,
                            f"train_{name}_{tag}_profile.txt", "6 train")
    rec["times"] = times
    for name in calls:
        say(f"[6 train] {name.replace('_', ' ')} (informational; "
            "synchronised host clock, device batches): "
            + "; ".join(
                f"cuDNN TF32 {tag[5:]} {times[name + '_ms'][tag]:.2f} ms,"
                f" peak device memory "
                f"{times[name + '_peak_gib'][tag]:.2f} GiB"
                for tag in ("tf32_on", "tf32_off")))
    rec["phase_s"] = time.perf_counter() - t_phase
    say(f"[6 train] phase 6 took {rec['phase_s']:.1f} s")
    return rec


# --- phase 7: convert ------------------------------------------------------

def finite_json(rec: dict) -> bool:
    return all(v is not None and math.isfinite(v) for v in rec.values()
               if not isinstance(v, str))


def phase_convert(dev, run: str, corpus: str, out: str) -> dict:
    """The serving CLIs on the checkpoint of training run ``run`` and its
    corpus, writing under ``out``, launch counters zeroed just before and
    read just after each call."""
    import importlib.util
    import torch
    from tpuvc_torch.cli import convert as cli_convert
    from tpuvc_torch.cli import evaluate as cli_evaluate
    from tpuvc_torch.convert import pipeline
    from tpuvc_torch.io import corpus as corpus_io
    from tpuvc_torch.io.wav import read_wav
    from tpuvc_torch.ops._build import read_counts, reset_counts
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    speakers = corpus_io.read_speakers(os.path.join(corpus, "etc"))
    n_test = len(corpus_io.list_wavs(corpus, corpus_io.TEST_SPLIT,
                                     speakers[0]))
    src, trg = speakers[0], speakers[-1]
    common = ["--checkpoint", run, "--corpus", corpus, "--device", dev.type]
    rec: dict = {}

    def drive(name, fn, argv, kernels=()):
        sync()
        reset_counts()
        t0 = time.perf_counter()
        res = fn(argv)
        sync()
        wall = time.perf_counter() - t0
        launches = read_counts()
        missing = [k for k in kernels if launches[k] == 0]
        if missing and cuda:
            raise AssertionError(f"{name} did not launch {missing}")
        rec[name] = {"wall_s": wall, "launches": launches}
        return res, wall, launches

    def check_wavs(name, paths):
        secs = 0.0
        for path in paths:
            y, fs = read_wav(path)
            if not (np.all(np.isfinite(y)) and np.std(y) > 1e-4):
                raise AssertionError(f"{name}: {path} is not finite or is "
                                     "silent")
            secs += len(y) / fs
        return secs

    # all pairs, one batched call
    outs, wall, launches = drive(
        "all_pairs", cli_convert.main,
        common + ["--all_pairs", "--transfer-encoding", "ulaw8", "--output",
                  os.path.join(out, "all_pairs")],
        path_kernels("default"))
    want = len(speakers) * n_test * (len(speakers) - 1)
    if len(outs) != want:
        raise AssertionError(f"all pairs: {len(outs)} files for {want}")
    if cuda and launches["events"] != 1:
        raise AssertionError(f"all pairs took {launches['events']} batched "
                             "calls for one")
    secs = check_wavs("all pairs", outs)
    rec["all_pairs"].update(files=len(outs), audio_s=secs,
                            audio_s_per_s=secs / wall)
    say(f"[7 convert] cli.convert --all_pairs --transfer-encoding ulaw8: "
        f"{len(outs)} conversions ({len(speakers)} speakers x {n_test} test "
        f"utterances x {len(speakers) - 1} targets, {secs:.1f} s of audio) "
        f"in {wall:.3f} s with start-up = {secs / wall:.2f} audio s per "
        f"wall s; kernel launches {launches}")

    # a decim-2 Harvest pair, with a spectrogram where matplotlib exists
    out_h = os.path.join(out, "harvest_decim2")
    outs, wall, launches = drive(
        "harvest_decim2", cli_convert.main,
        common + ["--src", src, "--trg", trg, "--f0-method", "harvest",
                  "--harvest-decim", "2", "--save_spectrogram", "--output",
                  out_h], path_kernels("harvest_decim2"))
    check_wavs("harvest decim 2", outs)
    pngs = [f for f in os.listdir(out_h) if f.endswith(".png")]
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    if len(pngs) != (len(outs) if has_mpl else 0):
        raise AssertionError(f"--save_spectrogram wrote {len(pngs)} PNGs "
                             f"for {len(outs)} files (matplotlib "
                             f"{'present' if has_mpl else 'absent'})")
    say(f"[7 convert] cli.convert {src}->{trg} --f0-method harvest "
        f"--harvest-decim 2 --save_spectrogram: {len(outs)} files in "
        f"{wall:.3f} s, {len(pngs)} PNGs (matplotlib "
        f"{'present' if has_mpl else 'absent'}); kernel launches {launches}")

    # a streamed pair
    outs, wall, launches = drive(
        "streaming", cli_convert.main,
        common + ["--src", src, "--trg", trg, "--streaming", "--output",
                  os.path.join(out, "streaming")],
        path_kernels("default"))
    check_wavs("streaming", outs)
    say(f"[7 convert] cli.convert {src}->{trg} --streaming: {len(outs)} "
        f"files in {wall:.3f} s; kernel launches {launches}")

    # load_converter on the card and on the CPU, the same noise
    x = read_wav(corpus_io.list_wavs(corpus, corpus_io.TEST_SPLIT,
                                     src)[0])[0]
    real = pipeline.synthesis_noise
    pipeline.synthesis_noise = lambda seeds, n, d: real(seeds, n,
                                                        "cpu").to(d)
    try:
        ys = [cli_convert.load_converter(run, corpus, device=d)[0].convert(
            x, src, trg, seed=5) for d in (dev, torch.device("cpu"))]
    finally:
        pipeline.synthesis_noise = real
    y_dev, y_cpu = (y.astype(np.float64) for y in ys)
    snr = 10 * math.log10(np.sum(y_cpu ** 2)
                          / max(np.sum((y_dev - y_cpu) ** 2), 1e-30))
    rec["card_vs_cpu_snr_db"] = snr
    say(f"[7 convert] load_converter on {dev.type} and on the CPU, "
        f"{len(x) / FS:g} s {src}->{trg}, the same noise: waveform SNR "
        f"{snr:.1f} dB (bound 30 dB)")
    if not snr >= 30.0:
        raise AssertionError(f"load_converter: card and CPU disagree: SNR "
                             f"{snr:.1f} dB")

    # the evaluation CLI in both modes
    rt, wall, launches = drive(
        "evaluate_round_trip", cli_evaluate.main,
        ["--corpus", corpus, "--limit", "4", "--device", dev.type],
        path_kernels("default", model=False))
    if not (finite_json(rt) and rt["mean"] < 8.0):
        raise AssertionError(f"cli.evaluate round trip: {rt}")
    cv, wall_cv, launches_cv = drive(
        "evaluate_conversion", cli_evaluate.main,
        common + ["--src", src, "--trg", trg],
        path_kernels("default", model=False))
    if not (finite_json(cv) and cv["n_utterances"] == n_test):
        raise AssertionError(f"cli.evaluate conversion: {cv}")
    rec["evaluate_round_trip"]["result"] = rt
    rec["evaluate_conversion"]["result"] = cv
    say(f"[7 convert] cli.evaluate round trip in {wall:.3f} s: {rt}; "
        f"kernel launches {launches}")
    say(f"[7 convert] cli.evaluate --checkpoint {src}->{trg} in "
        f"{wall_cv:.3f} s: {cv}; kernel launches {launches_cv}")
    return rec


# --- phase 8: parallel ----------------------------------------------------

def parallel_mesh(dev):
    """Every card, or the one device twice where there is one: a virtual
    mesh, on which the sharding, the dispatch threads and the gather run
    for real."""
    import torch
    from tpuvc_torch.parallel import mesh as mesh_lib
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        return mesh_lib.make_mesh()
    return mesh_lib.make_mesh(devices=[dev, dev])


def snr_db(ref, got) -> float:
    ref, got = (np.asarray(v, np.float64) for v in (ref, got))
    return 10 * math.log10(np.sum(ref ** 2)
                           / max(np.sum((got - ref) ** 2), 1e-30))


def min_snr_db(refs, gots) -> float:
    if len(refs) != len(gots) or any(np.shape(a) != np.shape(b)
                                     for a, b in zip(refs, gots)):
        raise AssertionError("outputs differ in number or shape")
    return min(snr_db(a, b) for a, b in zip(refs, gots))


def phase_parallel(dev, state, corpus: str, run: str, all_pairs_dir: str,
                   tmp: str, batch: int = 128, dur_s: float = 4.0,
                   fused_batch: int = 32, n_streams: int = 8,
                   stream_s: float = 2.5, long_s: float = 30.0,
                   arch_path: str = TRAIN_ARCH,
                   step_batch: int | None = None,
                   timed_steps: int = 5) -> dict:
    """The port's distributed surfaces on ``dev``, launch counters zeroed
    just before and read just after each call; any failure raises."""
    import torch
    from tpuvc_torch.cli import convert as cli_convert
    from tpuvc_torch.convert.pipeline import Converter
    from tpuvc_torch.convert.streaming import MultiStreamConverter
    from tpuvc_torch.data.dataset import FrameDataset
    from tpuvc_torch.data.normalizer import Tanhize
    from tpuvc_torch.dsp.world import analyze
    from tpuvc_torch.io.wav import read_wav
    from tpuvc_torch.ops._build import read_counts, reset_counts
    from tpuvc_torch.parallel import distributed, dryrun
    from tpuvc_torch.parallel.frame_sharding import analyze_sharded
    from tpuvc_torch.train import steps as steps_lib
    from tpuvc_torch.utils.config import Architecture
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_phase = time.perf_counter()
    mesh = parallel_mesh(dev)
    n = mesh.size
    where = f"a mesh of {n} ({', '.join(map(str, mesh.devices))})"
    rec: dict = {"mesh": [str(d) for d in mesh.devices]}
    names = lambda ids: [SPEAKERS[i] for i in ids]  # noqa: E731

    def counted(fn):
        sync()
        reset_counts()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, time.perf_counter() - t0, read_counts()

    def per_shard(name, one, dp, kernels, global_kernels=()):
        """On the card: every kernel of the path launched by the unsharded
        call, and the sharded call launched it once per shard (the global
        stages' kernels once)."""
        if not cuda:
            return
        bad = [k for k in kernels if one[k] == 0 or dp[k] != (
            one[k] if k in global_kernels else n * one[k])]
        if bad:
            raise AssertionError(f"{name}: launches {dp} over {n} shards "
                                 f"against {one} unsharded ({bad})")

    # DP serving on the default and the fused path (one WorldConfig)
    xs_all, src_all = batch_of(np.random.default_rng(8),
                               max(batch, fused_batch), dur_s)
    assets = make_assets(xs_all[:16], src_all[:16], path_cfg("default"), dev)
    for path, b in (("default", batch), ("fused", fused_batch)):
        cfg = path_cfg(path)
        model = path_model(path, state, dev)
        xs, src = xs_all[:b], src_all[:b]
        trg = [(i * 7 + 3) % 10 for i in range(b)]
        convs = {enc: Converter(model, assets, cfg, transfer_encoding=enc,
                                device=dev) for enc in ("ulaw8", "float32")}

        def call(m, enc="ulaw8"):
            return convs[enc].convert_batch(xs, names(src), names(trg),
                                            seed=0, mesh=m)

        call(None)
        call(mesh)                                    # replicas, warm-up
        _, _, one = counted(lambda: call(None))
        _, _, dp = counted(lambda: call(mesh))
        per_shard(path, one, dp, path_kernels(path))
        def in_turn():
            # the shards' work without the threads: one unsharded call
            # per shard, one after the other
            k = b // n
            for i in range(n):
                convs["ulaw8"].convert_batch(
                    xs[i * k:(i + 1) * k], names(src[i * k:(i + 1) * k]),
                    names(trg[i * k:(i + 1) * k]), seed=i * k)

        lat = {"one": [], "dp": [], "in_turn": []}
        for _ in range(3):
            for k, fn in (("one", lambda: call(None)),
                          ("dp", lambda: call(mesh)), ("in_turn", in_turn)):
                lat[k].append(counted(fn)[1])
        snr = min_snr_db(call(None, "float32"), call(mesh, "float32"))
        rate = {k: b * dur_s / min(v) for k, v in lat.items()}
        rec[path] = {"batch": b, "audio_s_per_s": rate, "latency_s": lat,
                     "launches_one": one, "launches_dp": dp,
                     "dp_vs_one_snr_db": snr}
        say(f"[8 parallel] {path}: batch {b} x {dur_s:g} s over {where}: "
            f"{rate['dp']:.2f} audio s per wall s sharded against "
            f"{rate['one']:.2f} unsharded and {rate['in_turn']:.2f} for the "
            f"{n} shards' calls in turn without threads, in the same run "
            f"(best of 3; latencies "
            f"{', '.join(f'{v:.4f}' for v in lat['dp'])} / "
            f"{', '.join(f'{v:.4f}' for v in lat['one'])} / "
            f"{', '.join(f'{v:.4f}' for v in lat['in_turn'])} s); kernel "
            f"launches sharded {dp}, unsharded {one}; sharded vs unsharded "
            f"float32 waveforms: SNR min {snr:.1f} dB (bound 40 dB)")
        if not snr >= 40.0:
            raise AssertionError(f"{path}: sharded and unsharded disagree: "
                                 f"SNR {snr:.1f} dB")
        del convs, model

    # concurrent streams, each tick split over the mesh
    conv = Converter(path_model("default", state, dev), assets,
                     path_cfg("default"), device=dev)
    rng = np.random.default_rng(9)
    pairs = [(SPEAKERS[i % 10], SPEAKERS[(i + 3) % 10])
             for i in range(n_streams)]
    xs = [utterance(rng, i % 10, stream_s) for i in range(n_streams)]

    def streams(m):
        ms = MultiStreamConverter(conv, pairs, chunk_s=1.0, seed=3, mesh=m)
        outs = [[ms.push(i, x)] for i, x in enumerate(xs)]
        for i, tail in enumerate(ms.flush_all()):
            outs[i].append(tail)
        return [np.concatenate(o) for o in outs]

    ys_one, wall_one, one = counted(lambda: streams(None))
    ys_dp, wall_dp, dp = counted(lambda: streams(mesh))
    missing = unlaunched(dp, model=False) if cuda else []
    snr = min_snr_db(ys_one, ys_dp)
    rec["multistream"] = {"streams": n_streams, "wall_s": [wall_one,
                                                           wall_dp],
                          "launches_dp": dp, "dp_vs_one_snr_db": snr}
    say(f"[8 parallel] MultiStreamConverter: {n_streams} streams of "
        f"{stream_s:g} s in 1 s chunks over {where} in {wall_dp:.3f} s "
        f"(unsharded {wall_one:.3f} s); kernel launches {dp}; per stream "
        f"against the unsharded ticks: SNR min {snr:.1f} dB (bound 40 dB)")
    if missing or not snr >= 40.0:
        raise AssertionError(f"MultiStreamConverter over the mesh: missing "
                             f"launches {missing}, SNR {snr:.1f} dB")
    del conv

    # one long utterance, its frames split over the mesh
    cfg = path_cfg("default")
    rng = np.random.default_rng(10)
    x = np.concatenate([utterance(rng, i % 10, 3.0)
                        for i in range(int(math.ceil(long_s / 3.0)))])
    x = x[:int(long_s * FS)]
    ref, wall_one, one = counted(lambda: analyze(x, cfg, device=dev))
    got, wall_dp, dp = counted(lambda: analyze_sharded(x, mesh, cfg))
    rels = {}
    for name, a, r in zip(("f0", "sp", "ap"), got, ref):
        if a.shape != r.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"analyze_sharded {name}: shape "
                                 f"{tuple(a.shape)} vs {tuple(r.shape)}, "
                                 "or non-finite")
        rels[name] = ((a - r).abs().max()
                      / r.abs().max().clamp(min=1e-12)).item()
    per_shard("analyze_sharded", one, dp,
              path_kernels("default", model=False),
              ("events", "scan", "extend"))
    rec["analyze_sharded"] = {"seconds": long_s, "wall_s": [wall_one,
                                                            wall_dp],
                              "launches": dp, "rel_err": rels}
    say(f"[8 parallel] analyze_sharded of {long_s:g} s "
        f"({got.f0.shape[0]} frames) over {where} in {wall_dp:.3f} s "
        f"(analyze {wall_one:.3f} s); kernel launches {dp} (analyze {one});"
        f" relative error to analyze "
        + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
        + " (bound 1e-3)")
    if not all(v < 1e-3 for v in rels.values()):
        raise AssertionError(f"analyze_sharded deviates: {rels}")

    # two gloo ranks on one device against one process: a full VAW-GAN
    # step of phase 6's corpus, in float32 (TF32 off)
    arch = Architecture.load(os.path.join(ROOT, arch_path))
    b = step_batch or arch.training.batch_size
    ds = FrameDataset.from_bin_dir(corpus)
    stream = ds.batches(b, seed=0, normalizer=Tanhize.from_etc(
        os.path.join(corpus, "etc")))
    xs, ys = zip(*(next(stream) for _ in range(arch.training.n_unroll + 1)))
    batch_t = {"x_crit": torch.from_numpy(np.stack(xs[:-1])),
               "y_crit": torch.from_numpy(np.stack(ys[:-1])),
               "x_gen": torch.from_numpy(xs[-1]),
               "y_gen": torch.from_numpy(ys[-1])}
    noise = steps_lib.vawgan_noise(steps_lib.step_generator(0, 0, dev), b,
                                   arch)
    noise = steps_lib.VAWGANNoise(noise.z_crit.cpu(), noise.gp.cpu(),
                                  noise.z_gen.cpu())
    t0 = time.perf_counter()
    ranks = dryrun.run_dp_step(
        {"arch": arch.to_json(), "params": None, "seed": 0,
         "batch": batch_t, "noise": noise, "device": dev.type,
         "backend": "gloo", "timed_steps": timed_steps}, 2, tmp,
        env=None if cuda else {"OMP_NUM_THREADS": "1"}, timeout=900.0)
    wall_ranks = time.perf_counter() - t0
    with dryrun.strict_float32():
        st = dryrun.make_state(arch, None, 0, dev)
        seen_g, seen_d = record_grads(st.opt_g), record_grads(st.opt_d)
        m = {k: float(v) for k, v in dryrun.take_step(st, batch_t,
                                                      noise).items()}
        want = dryrun.step_params(st)
        lr = arch.training.lr
        for r in ranks[1:]:
            if any(not torch.equal(p, ranks[0]["params"][mod][k])
                   for mod, ps in r["params"].items()
                   for k, p in ps.items()):
                raise AssertionError("the two ranks' parameters differ")
        got_m = ranks[0]["metrics"]
        bad = [k for k in m if abs(got_m[k] - m[k])
               > STEP_RTOL * abs(m[k]) + STEP_ATOL]
        if bad:
            raise AssertionError(f"2-rank step vs one process: {bad} "
                                 f"differ ({got_m} vs {m})")
        worst_g = params_agree(ranks[0]["params"]["gen"], want["gen"],
                               named_grads(st.gen, seen_g), lr, PARAM_FRAC,
                               PARAM_TOL)
        worst_d = params_agree(ranks[0]["params"]["critic"],
                               want["critic"], named_grads(st.critic,
                                                           seen_d),
                               lr, PARAM_FRAC, PARAM_TOL)
        one_ms = step_ms(lambda: dryrun.take_step(st, batch_t, noise), dev,
                         timed_steps)
    rel = max(abs(got_m[k] - m[k]) / max(abs(m[k]), 1e-30) for k in m)
    rec["train_2rank"] = {"batch": b, "devices": [r["device"]
                                                 for r in ranks],
                          "max_rel_err": rel, "gen_err_lr": worst_g,
                          "critic_err_lr": worst_d,
                          "step_ms_2rank": [r["step_ms"] for r in ranks],
                          "step_ms_one": one_ms, "wall_s": wall_ranks}
    say(f"[8 parallel] VAW-GAN step (batch {b}, float32, TF32 off) as two "
        f"gloo ranks on {', '.join(r['device'] for r in ranks)} (each on "
        f"its {b // 2} rows, gradients averaged by hand) against one "
        f"process on {dev}: ranks equal; loss dict max relative error "
        f"{rel:.3e} (bound rtol {STEP_RTOL:g} + atol {STEP_ATOL:g}); "
        f"parameters, in lr, generator {worst_g['significant']:.3e} / "
        f"{worst_g['rest']:.3e}, critic {worst_d['significant']:.3e} / "
        f"{worst_d['rest']:.3e} (phase 6's rule); {timed_steps} more steps: "
        f"{max(r['step_ms'] for r in ranks):.2f} ms per step on two ranks "
        f"against {one_ms:.2f} ms in one process (the ranks' call "
        f"{wall_ranks:.1f} s with start-up)")
    del st

    # a one-rank world on the card's own backend: init and all-reduce
    port = dryrun.free_port()
    env = {"COORDINATOR_ADDRESS": f"localhost:{port}", "NUM_PROCESSES": "1",
           "PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        distributed.ensure_initialized("nccl" if cuda else "gloo")
        pg = distributed.global_mesh(dev.type)
        backend = torch.distributed.get_backend(pg.group)
        t = torch.arange(1.0, 5.0, device=pg.devices[0])
        (r,) = steps_lib.all_reduce_mean([t], pg.group)
        sync()
        ok = bool(torch.equal(r, t)) and pg.size == 1
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rec["one_rank"] = {"backend": backend, "device": str(pg.devices[0]),
                       "ok": ok}
    say(f"[8 parallel] one-rank world: backend {backend} on "
        f"{pg.devices[0]}, all-reduce {'exact' if ok else 'WRONG'}")
    if not ok:
        raise AssertionError("one-rank all-reduce changed its input")

    # the conversion CLI, sharded over every card, against phase 7's files
    out_dp = os.path.join(tmp, "all_pairs_dp")
    outs, wall, launches = counted(lambda: cli_convert.main(
        ["--checkpoint", run, "--corpus", corpus, "--device", dev.type,
         "--all_pairs", "--transfer-encoding", "ulaw8", "--data_parallel",
         "--output", out_dp]))
    ref_names = sorted(os.listdir(all_pairs_dir))
    if sorted(os.path.basename(o) for o in outs) != ref_names:
        raise AssertionError("cli.convert --data_parallel wrote other files "
                             "than phase 7")
    snr = min_snr_db([read_wav(os.path.join(all_pairs_dir, f))[0]
                      for f in ref_names],
                     [read_wav(os.path.join(out_dp, f))[0]
                      for f in ref_names])
    missing = unlaunched(launches, model=False) if cuda else []
    rec["cli_data_parallel"] = {"files": len(outs), "wall_s": wall,
                                "launches": launches,
                                "vs_phase7_snr_db": snr}
    say(f"[8 parallel] cli.convert --all_pairs --data_parallel "
        f"--transfer-encoding ulaw8: {len(outs)} files in {wall:.3f} s "
        f"with start-up, over every card "
        f"({torch.cuda.device_count() if cuda else 1}); kernel launches {launches}; against phase 7's files: SNR min "
        f"{snr:.1f} dB (bound 40 dB)")
    if missing or not snr >= 40.0:
        raise AssertionError(f"cli.convert --data_parallel: missing "
                             f"launches {missing}, SNR {snr:.1f} dB")
    rec["phase_s"] = time.perf_counter() - t_phase
    say(f"[8 parallel] phase 8 took {rec['phase_s']:.1f} s")
    return rec


# --- phase 9: bench ---------------------------------------------------------

# the keys of the JAX entry points' JSON (scripts/compute_only.py;
# bench_stages.py's ``results``)
BENCH_KEYS = {
    "compute_only": {"metric", "value", "unit", "s_per_call", "batch",
                     "utterance_s", "k", "d2s_impl", "device"},
    "stages": {"dio", "stonemask", "cheaptrick", "d4c_group_delay",
               "d4c_nccf", "synthesis", "vae(bf16)", "excitation"},
}


def sync_sites(dev, batch: int, dur_s: float) -> dict:
    """Host syncs hidden in one default call (ulaw8, no copy to the host)
    after a warm-up one: every synchronising operation that
    torch.cuda.set_sync_debug_mode("warn") reports while the call runs,
    counted by the innermost line of the port that led to it (a
    report with no line of the port on the stack, as switching the mode
    can give, is counted apart); the record keeps the 12 lines with the
    most."""
    import collections
    import traceback
    import warnings
    import torch
    from tpuvc_torch.bench import common
    from tpuvc_torch.ops import ulaw
    model, arch = common.seeded_model(dev)
    base = common.device_call(model)
    call = lambda *a: ulaw.ulaw_encode(base(*a))  # noqa: E731
    args = common.on_device(common.make_inputs(batch, dur_s,
                                               y_dim=arch.y_dim), dev)
    call(*args)
    torch.cuda.synchronize()
    sites = collections.Counter()
    outside = []
    pkg = os.path.join(ROOT, "tpuvc_torch")

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        own = [f for f in traceback.extract_stack()
               if f.filename.startswith(pkg)]
        if not own:
            outside.append(f"{filename}:{lineno}")
            return
        sites[f"{os.path.relpath(own[-1].filename, ROOT)}:"
              f"{own[-1].lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"count": sum(sites.values()), "sites": dict(sites.most_common(
        12)), "n_sites": len(sites), "outside_the_call": outside}


def phase_bench(dev, batch: int = 128, dur_s: float = 4.0, k: int = 2,
                reps: int = 3, compute_k: int = 4,
                stage_batch: int = 32) -> dict:
    """The port's microbenchmarks (tpuvc_torch.bench) at reduced
    repetitions, counters zeroed just before and read just after each:
    each one's JSON keys equal the JAX script's, its path's kernels
    launched; then, on the card, one default call's host syncs."""
    import torch
    from tpuvc_torch.bench import compute_only, stages
    from tpuvc_torch.models.vae import serving_kernels
    from tpuvc_torch.ops._build import read_counts, reset_counts
    from tpuvc_torch.utils.config import Architecture
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {"launches": {}, "wall_s": {}}

    def entry(name, kernels, fn):
        sync()
        reset_counts()
        t0 = time.perf_counter()
        rec = fn()
        sync()
        out["wall_s"][name] = time.perf_counter() - t0
        out["launches"][name] = launches = read_counts()
        missing = [k for k in kernels if launches[k] == 0]
        if missing and cuda:
            raise AssertionError(f"bench {name} did not launch: {missing}")
        say(f"[9 bench] {name}: {out['wall_s'][name]:.1f} s; kernel "
            f"launches {launches}")
        say(json.dumps(rec))
        return rec

    def keys(name, rec, want):
        if set(rec) != want:
            raise AssertionError(f"bench {name}: keys {sorted(rec)} are not "
                                 f"the JAX script's {sorted(want)}")

    dio = path_kernels("default", model=False)
    out["compute_only"] = {}
    for impl in ("xla", "pallas"):
        rec = out["compute_only"][impl] = entry(
            f"compute_only {impl}",
            dio + serving_kernels(Architecture(d2s_impl=impl)),
            lambda: compute_only.measure(batch, dur_s, compute_k, impl,
                                         device=dev))
        keys("compute_only", rec, BENCH_KEYS["compute_only"])
    rec = out["stages"] = entry("stages", dio, lambda: stages.measure(
        stage_batch, dur_s, k=k, reps=reps, device=dev))
    keys("stages", rec["results"], BENCH_KEYS["stages"])
    if cuda:
        t0 = time.perf_counter()
        out["syncs"] = syncs = sync_sites(dev, batch, dur_s)
        say(f"[9 bench] host syncs in one default call of {batch} x "
            f"{dur_s:g} s (set_sync_debug_mode, {time.perf_counter() - t0:.1f}"
            f" s): {syncs['count']} at {syncs['n_sites']} lines; most: "
            f"{json.dumps(syncs['sites'])} (and "
            f"{len(syncs['outside_the_call'])} outside the call: "
            f"{syncs['outside_the_call']})")
    return out


# --- phase 10: quality -----------------------------------------------------

# the keys of the JAX quality scripts' results (scripts/roundtrip_classes.py
# per class, scale_validation.py, convergence_ab.py and its milestones,
# critic_conditioning_ab.py per arm) and of cli.evaluate's conversion record
QUALITY_KEYS = {
    "roundtrip": {"roundtrip_mcd_db", "retest_floor_db",
                  "measurement_limited"},
    "scale": {"corpus_gen_s", "config2_analyze_s", "config2_audio_s",
              "config2_x_realtime", "config3_train_s", "config3_steps",
              "config3_steps_per_s", "config3_final_metrics",
              "config4_convert_s", "config4_n_conversions",
              "config4_x_realtime", "quality_sf1_tm3"},
    "convergence": {"steps", "eval_every", "ab", "style", "models"},
    "milestone": {"step", "mcd_db", "mcd_dtw_db", "gv_ratio_db",
                  "ms_highband_ratio_db", "train_wall_s"},
    "critic": {"train_s", "curve", "eval_sf1_tm3"},
    "evaluate": {"metric", "unit", "step", "mean", "mean_dtw", "gv_ratio_db",
                 "ms_highband_ratio_db", "n_utterances"},
}
# a round trip on the card against the same function on the CPU port, with
# the same synthesis noise
ROUNDTRIP_CPU_DB = 0.1


def phase_quality(dev, tmp: str, n_train: int = 3, scale_steps: int = 20,
                  conv_steps: int = 300, eval_every: int = 100,
                  n_inner: int = 50, critic_ab_steps: int = 400,
                  critic_ab_every: int = 200, critic_steps: int = 30,
                  log_every: int = 10) -> dict:
    """The four quality studies through their ``main`` on ``dev``, corpora,
    runs and result files under ``tmp``, counters zeroed just before and
    read just after each: finite numbers, the JAX scripts' keys, the
    analysis kernels launched, round trips within ROUNDTRIP_CPU_DB of the
    CPU port's, MCD falling over every arm of the model and the critic
    A/B of convergence_ab."""
    import torch
    from tpuvc_torch.dsp import world
    from tpuvc_torch.dsp.constants import DEFAULT_WORLD
    from tpuvc_torch.ops._build import read_counts, reset_counts
    from tpuvc_torch.quality import (common, convergence_ab,
                                     critic_conditioning_ab,
                                     roundtrip_classes, scale_validation)
    from tpuvc_torch.quality.signals import make_speech_like
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    files = {"RECORD_PATH": os.path.join(tmp, "scale_validation_torch.json"),
             "CRITIC_AB_PATH": os.path.join(tmp, "critic_ab_torch.json")}
    saved = {k: getattr(common, k) for k in files}
    root = os.path.join(tmp, "vcc10")
    out = {"launches": {}, "wall_s": {}}
    say(f"[10 quality] sizes: round trips of the 5 classes (1 s each); "
        f"scale_validation --n_train {n_train} (10 speakers x {n_train} + 5 "
        f"utterances of 1.5 s) --steps {scale_steps}; convergence_ab --ab "
        f"model --steps {conv_steps} --eval_every {eval_every} --n_inner "
        f"{n_inner} on that corpus, then --ab critic --steps "
        f"{critic_ab_steps} --eval_every {critic_ab_every}; "
        f"critic_conditioning_ab --steps {critic_steps} --log_every "
        f"{log_every}; cuDNN TF32 on")

    def keys(name, rec, want):
        if set(rec) != want:
            raise AssertionError(f"quality {name}: keys {sorted(rec)} are "
                                 f"not the JAX script's {sorted(want)}")

    def study(name, mod, argv):
        sync()
        reset_counts()
        t0 = time.perf_counter()
        rec = mod.main(argv + ["--device", dev.type])
        sync()
        out["wall_s"][name] = time.perf_counter() - t0
        out["launches"][name] = launches = read_counts()
        missing = unlaunched(launches, model=False)
        if missing and cuda:
            raise AssertionError(f"quality {name} did not launch {missing}")
        bad = common.non_finite(rec, name)
        if bad:
            raise AssertionError(f"quality {name}: not finite at {bad}")
        say(f"[10 quality] {name}: {out['wall_s'][name]:.1f} s; kernel "
            f"launches {launches}")
        out[name] = rec
        return rec

    try:
        for k, v in files.items():
            setattr(common, k, v)
        with cudnn_tf32(True):
            rt = study("roundtrip_classes", roundtrip_classes, [])
            keys("roundtrip_classes", rt, set(roundtrip_classes.KINDS))
            for r in rt.values():
                keys("roundtrip_classes class", r, QUALITY_KEYS["roundtrip"])
            # the same function on the CPU port, drawing the card's noise
            real = world.synthesis_noise
            world.synthesis_noise = lambda seeds, n, device: real(
                seeds, n, dev).to(device)
            try:
                cpu = {kind: roundtrip_classes.roundtrip_mcd(
                    make_speech_like(kind, seed=0)[0], DEFAULT_WORLD,
                    device="cpu") for kind in roundtrip_classes.KINDS}
            finally:
                world.synthesis_noise = real
            gaps = {k: abs(rt[k]["roundtrip_mcd_db"] - cpu[k]) for k in cpu}
            out["roundtrip_card_vs_cpu_db"] = gaps
            say(f"[10 quality] round trip, card against the CPU port (same "
                f"noise): |MCD gap| {json.dumps(gaps)} dB")
            if max(gaps.values()) > ROUNDTRIP_CPU_DB:
                raise AssertionError(f"round trips: card and CPU differ by "
                                     f"more than {ROUNDTRIP_CPU_DB} dB")
            sv = study("scale_validation", scale_validation, [
                "--root", root, "--logdir", os.path.join(tmp, "scale_log"),
                "--steps", str(scale_steps), "--n_train", str(n_train)])
            keys("scale_validation", sv, QUALITY_KEYS["scale"])
            keys("scale_validation SF1->TM3", sv["quality_sf1_tm3"],
                 QUALITY_KEYS["evaluate"])
            # the model A/B, then the critic A/B (whose uncond arm is the
            # critic of the reference's earlier records) on the same corpus
            for ab, log, steps, every in (
                    ("model", "conv_log", conv_steps, eval_every),
                    ("critic", "critic_log", critic_ab_steps,
                     critic_ab_every)):
                name = "convergence_ab" + ("" if ab == "model" else "_" + ab)
                cv = study(name, convergence_ab, [
                    "--ab", ab, "--root", root,
                    "--logdir", os.path.join(tmp, log), "--steps",
                    str(steps), "--eval_every", str(every), "--n_inner",
                    str(n_inner), "--n_train", str(n_train)])
                keys(name, cv, QUALITY_KEYS["convergence"])
                for arm, traj in cv["models"].items():
                    for m in traj:
                        keys(f"{name} milestone", m,
                             QUALITY_KEYS["milestone"])
                    say(f"[10 quality] {name} {arm}: MCD "
                        f"{[m['mcd_db'] for m in traj]} dB at steps "
                        f"{[m['step'] for m in traj]}")
                    if not traj[-1]["mcd_db"] < traj[0]["mcd_db"]:
                        raise AssertionError(
                            f"{name} {arm}: MCD did not fall over "
                            f"training ({traj[0]['mcd_db']} -> "
                            f"{traj[-1]['mcd_db']} dB)")
            cr = study("critic_conditioning_ab", critic_conditioning_ab, [
                "--root", os.path.join(tmp, "ab_corpus"),
                "--logdir", os.path.join(tmp, "ab_log"),
                "--steps", str(critic_steps), "--log_every", str(log_every)])
            keys("critic_conditioning_ab", cr, {"unconditional",
                                                "conditional"})
            for r in cr.values():
                keys("critic_conditioning_ab arm", r, QUALITY_KEYS["critic"])
                keys("critic_conditioning_ab SF1->TM3", r["eval_sf1_tm3"],
                     QUALITY_KEYS["evaluate"])
        for path in files.values():
            bad = common.non_finite(common.read_record(path), path)
            if bad:
                raise AssertionError(f"quality: not finite at {bad}")
    finally:
        for k, v in saved.items():
            setattr(common, k, v)
    return out


# --- phase 11: host --------------------------------------------------------

def host_ms(fn, reps: int) -> float:
    """Median host wall time of fn() in ms over ``reps`` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def phase_host(dev, corpus: str, tmp: str, arch_path: str = TRAIN_ARCH,
               steps: int = 10, batch: int | None = None,
               gather: int = 256, reps: int = 20) -> dict:
    """The host-IO library (tpuvc_torch.native) and the Grain-order input
    pipeline (tpuvc_torch.data.grain_pipeline) on phase 6's corpus and
    normalizer: a second cached_library call is a hit; every WAV decoded
    natively is bit-equal to the scipy path; native record reads equal
    np.fromfile; a ``gather``-row gather with 1 and 8 threads equals numpy
    fancy indexing; grain_batches over the memory-mapped corpus for two
    epochs reads each epoch's permutation; ``steps`` VAW-GAN steps of
    ``arch_path`` (batch ``batch``, the architecture's by default) fed by
    grain_batches through make_trainer(...).train on ``dev`` log finite
    metrics and launch no hand kernel.  Host times (medians of ``reps``
    calls, of 3 passes for the WAVs) are informational."""
    import dataclasses
    import torch
    from tpuvc_torch import native
    from tpuvc_torch.data.dataset import FrameDataset
    from tpuvc_torch.data.grain_pipeline import epoch_order, grain_batches
    from tpuvc_torch.data.normalizer import Tanhize
    from tpuvc_torch.io import corpus as corpus_io
    from tpuvc_torch.io.wav import read_wav_scipy
    from tpuvc_torch.ops._build import read_counts, reset_counts
    from tpuvc_torch.train.trainer import make_trainer
    from tpuvc_torch.utils import aot_cache
    from tpuvc_torch.utils.config import Architecture
    t_phase = time.perf_counter()
    rec: dict = {}

    # the library: built at first use, a hit now
    path = native.build()
    compiles: list = []
    again = aot_cache.cached_library(
        native.TAG, native.BUILD_DIR, [native.SOURCE],
        native.CXX_FLAGS + native.LIBS, compiles.append, native._gxx())
    if again != path or compiles:
        raise AssertionError(f"host library: the second cached_library "
                             f"call compiled ({again} vs {path})")
    rec["library"] = os.path.relpath(path, ROOT)
    rec["build_s"] = native.build_seconds

    # WAV decoding: native against scipy, bit for bit
    wavs = [p for split in (corpus_io.TRAIN_SPLIT, corpus_io.TEST_SPLIT)
            for p in corpus_io.list_wavs(corpus, split)]
    for p in wavs:
        got = native.read_wav_native(p)
        ref, fs = read_wav_scipy(p)
        if (got is None or got[1] != fs
                or not np.array_equal(got[0].astype(np.float64), ref)):
            raise AssertionError(f"{p}: the native decoder differs from "
                                 "scipy's")
    rec["wav_ms_per_file"] = {
        "native": host_ms(lambda: [native.read_wav_native(p)
                                   for p in wavs], 3) / len(wavs),
        "scipy": host_ms(lambda: [read_wav_scipy(p) for p in wavs],
                         3) / len(wavs)}

    # records: native reads against np.fromfile and the memory map
    for p in corpus_io.list_bins(corpus, corpus_io.TRAIN_SPLIT):
        if not np.array_equal(native.read_f32_native(p),
                              np.fromfile(p, dtype=np.float32)):
            raise AssertionError(f"{p}: read_f32_native differs from "
                                 "np.fromfile")
    ds = FrameDataset.from_bin_dir(corpus)
    mapped = FrameDataset.from_bin_dir(corpus, mmap=True)
    if not (np.array_equal(ds.x, mapped.x)
            and np.array_equal(ds.y, mapped.y)):
        raise AssertionError("from_bin_dir: the native records differ "
                             "from the memory map's")
    n = len(ds)

    # the gather: 1 and 8 threads against numpy
    idx = np.random.default_rng(0).integers(0, n, gather)
    for threads in (1, 8):
        if not np.array_equal(native.gather_rows(ds.x, idx, threads),
                              ds.x[idx]):
            raise AssertionError(f"gather_rows ({threads} threads) "
                                 "differs from numpy")
    rec["gather_ms"] = {
        "native_1": host_ms(lambda: native.gather_rows(ds.x, idx, 1), reps),
        "native_8": host_ms(lambda: native.gather_rows(ds.x, idx, 8), reps),
        "numpy": host_ms(lambda: ds.x[idx], reps)}

    # grain_batches over the memory-mapped corpus, two epochs
    arch = Architecture.load(os.path.join(ROOT, arch_path))
    b = batch or arch.training.batch_size
    arch = dataclasses.replace(arch, training=dataclasses.replace(
        arch.training, batch_size=b))
    norm = Tanhize.from_etc(os.path.join(corpus, "etc"))
    t0 = time.perf_counter()
    stream = list(grain_batches(mapped, b, seed=0, normalizer=norm,
                                num_epochs=2))
    dt = time.perf_counter() - t0
    orders = [epoch_order(n, 0, e) for e in (0, 1)]
    if any(not np.array_equal(np.sort(o), np.arange(n)) for o in orders):
        raise AssertionError("grain_batches: an epoch is not a permutation")
    want = np.concatenate(orders)[:len(stream) * b]
    labels = np.concatenate([yb for _, yb in stream])
    rows = np.stack([norm.forward(ds.x[i]).astype(np.float32)
                     for i in want[:b]])
    if (len(stream) != 2 * n // b or not np.array_equal(labels, ds.y[want])
            or not np.array_equal(stream[0][0], rows)):
        raise AssertionError(f"grain_batches: {len(stream)} batches of {b} "
                             f"over 2 epochs of {n} frames, or labels or "
                             "rows out of the epochs' order")
    rec["grain"] = {"frames": n, "batch": b, "batches": len(stream),
                    "batches_per_s": len(stream) / dt}
    del stream
    say(f"[11 host] {rec['library']}: g++ "
        + (f"built it in {rec['build_s']:.3f} s at first use"
           if rec["build_s"] is not None else "did not run (on disk)")
        + f"; a second cached_library call was a hit; {len(wavs)} WAVs "
        f"bit-equal native vs scipy; native records equal np.fromfile's "
        f"and the memory map's ({n} frames); {gather}-row gathers with 1 "
        f"and 8 threads equal numpy's; grain_batches over the memory map: "
        f"2 epochs in {rec['grain']['batches']} batches of {b}, each epoch "
        "a permutation, labels and rows in its order")

    # full-width training fed by grain_batches
    run_dir = os.path.join(tmp, "grain_run")
    trainer = make_trainer(arch, run_dir, use_tensorboard=False,
                           device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with cudnn_tf32(True):
        sync()
        reset_counts()
        t0 = time.perf_counter()
        trainer.train(grain_batches(mapped, b, seed=0, normalizer=norm),
                      steps, log_every=1, save_every=steps)
        sync()
        rec["train_s"] = time.perf_counter() - t0
    trainer.close()
    launches = read_counts()
    with open(os.path.join(run_dir, "events", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    if ([r["step"] for r in logged] != list(range(1, steps + 1))
            or not all(math.isfinite(v) for r in logged
                       for v in r.values())
            or any(launches.values())):
        raise AssertionError(f"grain-fed training: logged {logged}, kernel "
                             f"launches {launches}")
    rec["train"] = {"steps": steps, "last": logged[-1]}
    say(f"[11 host] {steps} {arch.model} steps ({arch_path}, batch {b}, "
        f"n_unroll {arch.training.n_unroll}) on {dev} fed by grain_batches "
        f"through make_trainer(...).train in {rec['train_s']:.3f} s (with "
        f"start-up): every logged metric finite, last "
        + ", ".join(f"{k} {v:.4f}" for k, v in logged[-1].items()
                    if k not in ("step", "time")))
    w, g = rec["wav_ms_per_file"], rec["gather_ms"]
    rec["phase_s"] = time.perf_counter() - t_phase
    say(f"[11 host] host times of the card's machine (informational): WAV "
        f"decode {w['native']:.4f} ms per file native, {w['scipy']:.4f} "
        f"scipy; {gather}-row gather {g['native_1']:.4f} ms native 1 "
        f"thread, {g['native_8']:.4f} 8 threads (io.cc threads from 1024 "
        f"rows), {g['numpy']:.4f} numpy; grain_batches "
        f"{rec['grain']['batches_per_s']:.1f} batches/s of {b}")
    return rec


def profile_call(fn, out_dir: str, fname: str,
                 phase: str = "5 rate") -> dict:
    """torch.profiler over one call: device time by kernel (table in
    out_dir/fname), launches, the device-busy share of the call's wall
    time (kernels of one stream do not overlap), and the port's own
    kernels' launches and device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.device_time_total for e in kernels) / 1e6
    if not kernels:
        say(f"[{phase}] profile: the profiler saw no device events; device "
            "time by kernel not measured")
        return {"wall_s": wall, "device_busy_s": None, "device_events": 0}
    avg = prof.key_averages()
    table = avg.table(sort_by="self_device_time_total", row_limit=-1)
    port = {}                 # summed over a template's instantiations
    for e in avg:
        for fn in KERNEL_FUNCS:
            if fn in e.key:
                v = port.setdefault(fn, {"launches": 0, "device_ms": 0.0})
                v["launches"] += e.count
                v["device_ms"] += e.device_time_total / 1e3
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, fname)
    with open(path, "w") as f:
        f.write(table)
    say(f"[{phase}] profile: wall {wall:.4f} s (profiler on), device busy "
        f"{busy_s:.4f} s = {100 * busy_s / wall:.1f}% over {len(kernels)} "
        f"device events; table in {path}")
    say(f"[{phase}] profile: the port's kernels, device time per launch: "
        + ", ".join(f"{fn} {v['launches']} x "
                    f"{v['device_ms'] / max(v['launches'], 1):.4f} ms"
                    for fn, v in port.items()))
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_events": len(kernels), "port_kernels": port}


def yardsticks_of(sites) -> list:
    """The extra library yardsticks a kernel's sites were timed against."""
    return [k for k in sites[0] if k.startswith("library_")
            and k != "library_ms"]


def kernels_record(kern: dict, launches: dict,
                   vocoder: dict | None = None) -> dict:
    """The JSON record: one entry per kernel, at its first site; K13's
    from the vocoder phase where it ran, with its launches on the served
    pwg path."""
    out = []
    for name, src, rep, path in KERNELS:
        sites = kern[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep, "launches": launches[path][name],
                 "launches_path": path}
        if name in SUMMED:
            # every layer of one model call: times summed; the layers run
            # one after another, so the bound is the sum of each layer's
            # own, and bound_by names the kind that holds most of it
            by_bytes = sum(r["bound_ms"] for r in sites
                           if r["bound_by"] == "bytes")
            bound = sum(r["bound_ms"] for r in sites)
            entry.update(
                max_abs_err=max(r["max_abs_err"] for r in sites),
                **{k: sum(r[k] for r in sites) for k in (
                    "ms", "b2b_ms", "plain_ms", "library_ms",
                    *yardsticks_of(sites))},
                bound_ms=bound,
                bound_by="bytes" if 2 * by_bytes >= bound else "operations",
                site=f"all {len(sites)} sites of one model call")
            if "fp32_ops_ms" in sites[0]:
                # the first design's float32 FMA bound, counted as then
                entry["bound_fp32_fma_ms"] = max(
                    sum(r["bytes_ms"] for r in sites),
                    sum(r["fp32_ops_ms"] for r in sites))
        else:
            entry.update({k: v for k, v in sites[0].items() if k in (
                "max_abs_err", "ms", "b2b_ms", "plain_ms", "bound_ms",
                "bound_by", "bound_full_row_ms", "bound_all_lanes_ms",
                "dependent_steps", "throughput_bound_ms", "library_ms",
                "site")})
        out.append(entry)
    if vocoder is not None:
        out.append(vocoder_record(vocoder, launches["pwg"]["pwg"]))
    return {"kernels": out}


def vocoder_record(vocoder: dict, launches: int) -> dict:
    """K13's entry of the JSON record, at its first site: its launches
    are those of the pwg path's served requests (phase 4)."""
    site = vocoder["sites"][0]
    return {"name": "pwg", "route": "cuda",
            "source": "tpuvc_torch/csrc/pwg.cu",
            "replaces": "none (the JAX package has no vocoder)",
            "launches": launches, "launches_path": "pwg",
            "in_call_ms": vocoder["in_call_ms"],
            **{k: site[k] for k in (
                "max_abs_err", "ms", "b2b_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "site")}}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for chip_smoke.json (and the "
                    "profile tables); nothing is written without it")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler pass over one call of the "
                    "paths but nccf (needs --out)")
    args = ap.parse_args()
    if args.profile and not args.out:
        ap.error("--profile needs --out")
    name, smi = phase_device()
    import torch
    dev = torch.device("cuda")
    phase_build()
    state = build_state()
    kern = phase_kernels(dev, state)
    torch.cuda.empty_cache()
    vocoder = phase_vocoder(dev, profile_dir=args.out)
    torch.cuda.empty_cache()
    launches, snrs, transfers, rates, entry = {}, {}, {}, {}, None
    for path in PATHS:
        conv, launches[path], snrs[path], transfers[path] = phase_serve(
            path, dev, state)
        if path == "fused":
            entry = phase_entry_points(conv, dev)
        rates[path] = phase_rate(
            path, conv, smi, dev, PATHS[path][1],
            profile_dir=(args.out if args.profile and path != "nccf"
                         else None),
            budget_batch=128 if path == "harvest" else None)
        del conv
        torch.cuda.empty_cache()
    model_s = {p: rates[p]["stages_s"]["model"] for p in ("default", "fused")}
    say(f"[5 rate] model stage (encode + decode) at batch "
        f"{PATHS['fused'][1]} x 4 s: default {model_s['default']:.4f} s, "
        f"fused {model_s['fused']:.4f} s")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        train = phase_train(dev, tmp,
                            profile_dir=args.out if args.profile else None)
        say(f"[6 train] card: {smi}")
        t0 = time.perf_counter()
        convert = phase_convert(dev, train["run_dir"], train["corpus"],
                                os.path.join(tmp, "converted"))
        convert["phase_s"] = time.perf_counter() - t0
        say(f"[7 convert] phase 7 took {convert['phase_s']:.1f} s; card: "
            f"{smi}")
        torch.cuda.empty_cache()
        parallel = phase_parallel(dev, state, train["corpus"],
                                  train["run_dir"],
                                  os.path.join(tmp, "converted",
                                               "all_pairs"), tmp)
        say(f"[8 parallel] card: {smi}")
        torch.cuda.empty_cache()
        host = phase_host(dev, train["corpus"], tmp)
        say(f"[11 host] phase 11 took {host['phase_s']:.1f} s; card: "
            f"{smi}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench = phase_bench(dev)
    say(f"[9 bench] phase 9 took {time.perf_counter() - t0:.1f} s; card: "
        f"{smi}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        quality = phase_quality(dev, tmp)
    quality["phase_s"] = time.perf_counter() - t0
    say(f"[10 quality] phase 10 took {quality['phase_s']:.1f} s; card: "
        f"{smi}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": smi, "kernels": kern, "vocoder": vocoder,
                       "launches": launches,
                       "card_vs_cpu_snr_db": snrs,
                       "transfer_snr_db": transfers, "entry_points": entry,
                       "rate": rates, "train": train, "convert": convert,
                       "parallel": parallel, "host": host,
                       "bench": bench, "quality": quality},
                      f, indent=1)
    say(f"[5 rate] card: {smi}")
    say(json.dumps(kernels_record(kern, launches, vocoder)))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
