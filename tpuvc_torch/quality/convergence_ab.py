"""Convergence training and the model A/Bs: the port of
``scripts/convergence_ab.py``.

    python -m tpuvc_torch.quality.convergence_ab [--steps 30000]
        [--eval_every 5000] [--n_inner 100] [--n_train 50]
        [--style vowel|hard] [--ab model|output_activation|all|critic|alpha]
        [--alphas 25,50,100] [--root DIR] [--logdir DIR] [--device cuda|cpu]

Trains each arm on the synthetic VCC2016-shaped corpus through the
device-resident path (``train_resident``) up to each milestone, then scores
SF1 -> TM3 with ``cli.evaluate``: conversion MCD against the target's
parallel recording, its DTW-aligned form, and the sharpness axes
(mel-cepstral GV ratio, high-band modulation-spectrum ratio).  Arms
(``arms``): ``model`` VAW-GAN vs VAE; ``output_activation`` tanh vs linear
decoder head on the VAE; ``all`` both in one pass (the VAE-tanh arm
shared, written to both keys); ``critic`` unconditional vs
projection-conditioned critic; ``alpha`` the adversarial weight.  Each
milestone lands in ``<logdir>/partial_results.json``, so a killed run keeps
what it finished; the end result goes into ``common.RECORD_PATH`` under the
JAX script's key (``_hard`` suffix for the hard style).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from tpuvc_torch.cli import analyze, evaluate
from tpuvc_torch.cli.common import add_device_flag, apply_device
from tpuvc_torch.data import synthetic
from tpuvc_torch.data.dataset import FrameDataset
from tpuvc_torch.data.normalizer import Tanhize
from tpuvc_torch.quality import common
from tpuvc_torch.train.trainer import make_trainer
from tpuvc_torch.utils.config import Architecture

KEYS = {"model": "convergence_ab",
        "output_activation": "output_activation_ab",
        "critic": "critic_conditioning_ab",
        "alpha": "alpha_sweep"}


def arms(ab: str, alphas: str = "25,50,100") -> list[tuple[str, dict]]:
    """(name, architecture overrides) of each arm of the A/B ``ab``; a
    ``"training"`` entry overrides fields of ``Architecture.training``."""
    if ab == "model":
        # the critic's contribution at equal steps
        return [("VAWGAN", {"model": "VAWGAN", "trainer": "VAWGANTrainer"}),
                ("VAE", {"model": "VAE", "trainer": "VAETrainer"})]
    if ab == "output_activation":
        # decoder bounding: tanh head vs unbounded linear, both the VAE
        return [("tanh", {"model": "VAE", "trainer": "VAETrainer",
                          "output_activation": "tanh"}),
                ("linear", {"model": "VAE", "trainer": "VAETrainer",
                            "output_activation": "linear"})]
    if ab == "critic":
        # does the critic need the speaker code?
        return [("uncond", {"model": "VAWGAN", "trainer": "VAWGANTrainer",
                            "d_conditional": False}),
                ("cond", {"model": "VAWGAN", "trainer": "VAWGANTrainer",
                          "d_conditional": True})]
    if ab == "alpha":
        return [(f"alpha{a}", {"model": "VAWGAN", "trainer": "VAWGANTrainer",
                               "training": {"alpha": float(a)}})
                for a in alphas.split(",")]
    if ab == "all":
        # both A/Bs in one pass, the default VAE (tanh) arm shared
        return [("VAWGAN", {"model": "VAWGAN", "trainer": "VAWGANTrainer"}),
                ("tanh", {"model": "VAE", "trainer": "VAETrainer",
                          "output_activation": "tanh"}),
                ("linear", {"model": "VAE", "trainer": "VAETrainer",
                            "output_activation": "linear"})]
    raise ValueError(f"unknown A/B {ab!r}")


def arm_architecture(base: Architecture, overrides: dict) -> Architecture:
    overrides = dict(overrides)
    train_over = overrides.pop("training", None)
    arch = dataclasses.replace(base, **overrides)
    if train_over:
        arch = dataclasses.replace(
            arch, training=dataclasses.replace(arch.training, **train_over))
    return arch


def prepare(args) -> tuple:
    """The corpus (generated and analysed unless present) as the resident
    table: (Tanhize-normalised frames, speaker labels)."""
    if not os.path.isdir(os.path.join(args.root, "wav")):
        # hard style: parallel content across speakers, or its variable
        # syllable timing breaks the framewise "vs the target's parallel
        # recording" premise (data/synthetic.py make_corpus)
        synthetic.make_vcc2016_corpus(args.root, n_train=args.n_train,
                                      n_test=5, style=args.style,
                                      parallel=(args.style == "hard"))
        print(f"[conv] corpus generated (style={args.style}, parallel="
              f"{args.style == 'hard'})", flush=True)
    if not os.path.isdir(os.path.join(args.root, "bin")):
        analyze.main(["--corpus", args.root, "--quiet",
                      "--device", args.device])
        print("[conv] corpus analyzed", flush=True)
    ds = FrameDataset.from_bin_dir(args.root)
    norm = Tanhize.from_etc(os.path.join(args.root, "etc"))
    print(f"[conv] {len(ds)} frames resident", flush=True)
    return norm.forward(ds.x), ds.y


def train_arm(name: str, arch: Architecture, data, labels, args, device,
              on_milestone=None, seed: int = 0) -> list[dict]:
    """One arm: resident training from the trainer's ``seed`` to each
    milestone of ``args``, then cli.evaluate SF1 -> TM3; returns the
    trajectory.  ``on_milestone(traj)`` runs after each milestone."""
    run_dir = os.path.join(args.logdir, name.lower())
    os.makedirs(run_dir, exist_ok=True)
    arch.save(os.path.join(run_dir, "architecture.json"))
    trainer = make_trainer(arch, run_dir, seed=seed, use_tensorboard=False,
                           device=device)
    traj = []
    t0 = time.perf_counter()
    for milestone in range(args.eval_every, args.steps + 1,
                           args.eval_every):
        m = trainer.train_resident(data, labels, total_steps=milestone,
                                   n_inner=args.n_inner,
                                   save_every=args.eval_every)
        wall = round(time.perf_counter() - t0, 1)
        ev = evaluate.main(["--corpus", args.root, "--checkpoint", run_dir,
                            "--src", "SF1", "--trg", "TM3",
                            "--device", args.device])
        traj.append({"step": milestone, "mcd_db": ev["mean"],
                     "mcd_dtw_db": ev.get("mean_dtw"),
                     "gv_ratio_db": ev.get("gv_ratio_db"),
                     "ms_highband_ratio_db": ev.get("ms_highband_ratio_db"),
                     "train_wall_s": wall})
        print(f"[conv] {name} step {milestone}: MCD {ev['mean']} dB, GV "
              f"{ev.get('gv_ratio_db')} dB, MS-hi "
              f"{ev.get('ms_highband_ratio_db')} dB (wall {wall}s, metrics "
              f"{ {k: round(v, 3) for k, v in m.items()} })", flush=True)
        if on_milestone is not None:
            on_milestone(traj)
    trainer.close()
    return traj


def parser(doc: str = __doc__) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--root", default=os.path.join(common.RUNS_DIR, "vcc10"))
    p.add_argument("--logdir",
                   default=os.path.join(common.RUNS_DIR, "vcc10_conv"))
    p.add_argument("--steps", type=int, default=30000)
    p.add_argument("--eval_every", type=int, default=5000)
    p.add_argument("--n_inner", type=int, default=100)
    p.add_argument("--n_train", type=int, default=50)
    p.add_argument("--style", default="vowel", choices=["vowel", "hard"],
                   help="corpus difficulty: 'hard' = stop bursts, formant "
                        "glides, jitter/shimmer, variable speaking rate "
                        "(use a fresh --root/--logdir per style)")
    add_device_flag(p)
    return p


def main(argv: list[str] | None = None) -> dict:
    p = parser()
    p.add_argument("--ab", default="model",
                   choices=["model", "output_activation", "all", "critic",
                            "alpha"],
                   help="which A/B to run: 'model' = VAWGAN vs VAE; "
                        "'output_activation' = tanh vs linear decoder "
                        "output on the VAE; 'all' = three arms (VAWGAN, "
                        "VAE-tanh, VAE-linear) sharing the VAE-tanh arm, "
                        "results written to both keys; 'critic' = "
                        "unconditional vs projection-conditioned critic; "
                        "'alpha' = adversarial-weight sweep on the VAWGAN")
    p.add_argument("--alphas", default="25,50,100",
                   help="arms for --ab alpha")
    args = p.parse_args(argv)
    device = apply_device(args)

    common.start_launches(device)
    data, labels = prepare(args)
    base = Architecture.load(common.ARCH_PATH)
    results: dict = {"steps": args.steps, "eval_every": args.eval_every,
                     "ab": args.ab, "style": args.style, "models": {}}
    for name, overrides in arms(args.ab, args.alphas):
        def save_partial(traj, name=name):
            # survive a mid-run kill: finished milestones land on disk
            results["models"][name] = traj
            with open(os.path.join(args.logdir, "partial_results.json"),
                      "w") as f:
                json.dump(results, f, indent=2)

        train_arm(name, arm_architecture(base, overrides), data, labels,
                  args, device, save_partial)
    common.require_analysis_launches(device, "convergence_ab")

    sfx = "_hard" if args.style == "hard" else ""
    if args.ab == "all":
        m = results["models"]
        header = {k: results[k] for k in ("steps", "eval_every", "style")}
        entries = {
            "convergence_ab" + sfx: dict(
                header, ab="model",
                models={"VAWGAN": m["VAWGAN"], "VAE": m["tanh"]}),
            "output_activation_ab" + sfx: dict(
                header, ab="output_activation",
                models={"tanh": m["tanh"], "linear": m["linear"]})}
    else:
        entries = {KEYS[args.ab] + sfx: results}
    common.write_record(common.RECORD_PATH, entries, device)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
