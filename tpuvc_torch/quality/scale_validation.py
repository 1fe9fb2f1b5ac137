"""Scale validation run (BASELINE configs 2-4): the port of
``scripts/scale_validation.py``.

    python -m tpuvc_torch.quality.scale_validation [--root DIR]
        [--logdir DIR] [--steps 1500] [--n_train 50] [--fresh]
        [--device cuda|cpu]

Generates a 10-speaker VCC2016-shaped synthetic corpus (``n_train`` + 5
test utterances of 1.5 s per speaker), then on the card through the
port's CLIs:
  config 2: batched WORLD analysis of the whole corpus        (cli.analyze)
  config 3: VAW-GAN joint training, batch 256, N steps         (cli.train)
  config 4: all-pairs many-to-many conversion (90 pairs)       (cli.convert)
plus the conversion MCD of SF1 -> TM3 (cli.evaluate).  Wall-clock fields
are this machine's host clock around each CLI call.  Writes the JAX
script's keys into ``common.RECORD_PATH`` (the JAX script replaces its
file; the port merges into its own, which holds every study's record).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

from tpuvc_torch.cli import analyze, convert, evaluate, train
from tpuvc_torch.cli.common import add_device_flag, apply_device
from tpuvc_torch.data import synthetic
from tpuvc_torch.quality import common


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=os.path.join(common.RUNS_DIR, "vcc10"))
    p.add_argument("--logdir",
                   default=os.path.join(common.RUNS_DIR, "vcc10_logdir"))
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--n_train", type=int, default=50)
    p.add_argument("--fresh", action="store_true")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = apply_device(args)
    dev = ["--device", args.device]

    results: dict = {}
    if args.fresh:
        shutil.rmtree(args.root, ignore_errors=True)
        shutil.rmtree(args.logdir, ignore_errors=True)
    if not os.path.isdir(os.path.join(args.root, "wav")):
        t0 = time.perf_counter()
        synthetic.make_vcc2016_corpus(args.root, n_train=args.n_train,
                                      n_test=5)
        results["corpus_gen_s"] = round(time.perf_counter() - t0, 1)
        print(f"[scale] corpus generated in {results['corpus_gen_s']}s")

    common.start_launches(device)
    # config 2: batched analysis frontend
    t0 = time.perf_counter()
    analyze.main(["--corpus", args.root, "--quiet"] + dev)
    results["config2_analyze_s"] = round(time.perf_counter() - t0, 1)
    n_utt = 10 * (args.n_train + 5)
    audio_s = n_utt * 1.5
    results["config2_audio_s"] = audio_s
    results["config2_x_realtime"] = round(
        audio_s / results["config2_analyze_s"], 1)
    print(f"[scale] config2 analyze: {results['config2_analyze_s']}s "
          f"({results['config2_x_realtime']}x realtime incl. host I/O)")

    # config 3: VAW-GAN training
    t0 = time.perf_counter()
    run_dir = train.main(["--corpus", args.root, "--logdir", args.logdir,
                          "--architecture", common.ARCH_PATH,
                          "--steps", str(args.steps), "--no-tensorboard"]
                         + dev)
    results["config3_train_s"] = round(time.perf_counter() - t0, 1)
    results["config3_steps"] = args.steps
    results["config3_steps_per_s"] = round(
        args.steps / results["config3_train_s"], 2)
    metrics_path = os.path.join(run_dir, "events", "metrics.jsonl")
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        if lines:
            results["config3_final_metrics"] = {
                k: round(v, 3) for k, v in lines[-1].items()}
    print(f"[scale] config3 train: {results['config3_train_s']}s "
          f"({results['config3_steps_per_s']} steps/s)")

    # config 4: all-pairs conversion
    t0 = time.perf_counter()
    outs = convert.main(["--checkpoint", run_dir, "--corpus", args.root,
                         "--all_pairs"] + dev)
    results["config4_convert_s"] = round(time.perf_counter() - t0, 1)
    results["config4_n_conversions"] = len(outs)
    results["config4_x_realtime"] = round(
        len(outs) * 1.5 / results["config4_convert_s"], 1)
    print(f"[scale] config4 all-pairs: {len(outs)} conversions in "
          f"{results['config4_convert_s']}s "
          f"({results['config4_x_realtime']}x realtime incl. host I/O)")

    # quality: conversion MCD for SF1->TM3 (the reference headline pair)
    results["quality_sf1_tm3"] = evaluate.main(
        ["--corpus", args.root, "--checkpoint", run_dir, "--src", "SF1",
         "--trg", "TM3"] + dev)
    common.require_analysis_launches(device, "scale_validation")

    common.write_record(common.RECORD_PATH, results, device)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
