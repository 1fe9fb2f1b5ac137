"""Critic speaker-conditioning A/B: the port of
``scripts/critic_conditioning_ab.py``.

    python -m tpuvc_torch.quality.critic_conditioning_ab [--steps 600]
        [--log_every 25] [--root DIR] [--logdir DIR] [--device cuda|cpu]

Trains the VAW-GAN with an unconditional and a projection-conditioned
critic (``Architecture.d_conditional``) on the same data and seed through
``VAWGANTrainer.train`` over ``FrameDataset.batches``, and records each
arm's per-step training curve (its ``metrics.jsonl``), wall time and
SF1 -> TM3 conversion quality (``cli.evaluate``) into
``common.CRITIC_AB_PATH``; prints a markdown table of the curves.  The
decision-grade version is ``convergence_ab --ab critic``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import time

from tpuvc_torch.cli import analyze, evaluate
from tpuvc_torch.cli.common import add_device_flag, apply_device
from tpuvc_torch.data import synthetic
from tpuvc_torch.data.dataset import FrameDataset
from tpuvc_torch.data.normalizer import Tanhize
from tpuvc_torch.quality import common
from tpuvc_torch.train.trainer import VAWGANTrainer
from tpuvc_torch.utils.config import Architecture


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=os.path.join(common.RUNS_DIR,
                                                  "ab_corpus"))
    p.add_argument("--logdir", default=os.path.join(common.RUNS_DIR,
                                                    "ab_logdir"))
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--log_every", type=int, default=25)
    add_device_flag(p)
    args = p.parse_args(argv)
    device = apply_device(args)
    dev = ["--device", args.device]

    common.start_launches(device)
    if not os.path.isdir(os.path.join(args.root, "wav")):
        synthetic.make_vcc2016_corpus(args.root, n_train=8, n_test=2)
        analyze.main(["--corpus", args.root, "--quiet"] + dev)

    ds = FrameDataset.from_bin_dir(args.root)
    etc = os.path.join(args.root, "etc")
    try:
        norm = Tanhize.from_etc(etc)
    except FileNotFoundError:
        norm = ds.fit_normalizer()
        norm.save(etc)
    base = Architecture.load(common.ARCH_PATH)

    results: dict = {}
    for cond in (False, True):
        name = "conditional" if cond else "unconditional"
        arch = dataclasses.replace(base, d_conditional=cond)
        run_dir = os.path.join(args.logdir, name)
        shutil.rmtree(run_dir, ignore_errors=True)
        os.makedirs(run_dir)
        arch.save(os.path.join(run_dir, "architecture.json"))
        trainer = VAWGANTrainer(arch, run_dir, seed=0, use_tensorboard=False,
                                device=device)
        batches = ds.batches(arch.training.batch_size, normalizer=norm,
                             seed=0)
        t0 = time.perf_counter()
        trainer.train(batches, args.steps, log_every=args.log_every)
        wall = round(time.perf_counter() - t0, 1)
        trainer.close()

        with open(os.path.join(run_dir, "events", "metrics.jsonl")) as f:
            curve = [json.loads(ln) for ln in f if ln.strip()]
        ev = evaluate.main(["--corpus", args.root, "--checkpoint", run_dir,
                            "--src", "SF1", "--trg", "TM3"] + dev)
        results[name] = {
            "train_s": wall,
            "curve": [{k: round(v, 3) for k, v in m.items()}
                      for m in curve],
            "eval_sf1_tm3": ev,
        }
        print(f"[ab] {name}: {wall}s; final "
              f"{ {k: round(v, 3) for k, v in curve[-1].items()} }; "
              f"eval {ev}")
    common.require_analysis_launches(device, "critic_conditioning_ab")
    common.write_record(common.CRITIC_AB_PATH, results, device)

    print("\n| step | W_dist (uncond) | W_dist (cond) | l_G (uncond) "
          "| l_G (cond) |")
    print("|---|---|---|---|---|")
    cu = results["unconditional"]["curve"]
    cc = results["conditional"]["curve"]
    for mu, mc in zip(cu, cc):
        print(f"| {int(mu['step'])} | {mu.get('W_dist', float('nan')):.3f} "
              f"| {mc.get('W_dist', float('nan')):.3f} "
              f"| {mu.get('l_G', float('nan')):.3f} "
              f"| {mc.get('l_G', float('nan')):.3f} |")
    return results


if __name__ == "__main__":
    main()
