"""The port's trained-quality record on the card, study by study.

    python scripts/torch_quality_record.py PART [PART ...] [--out DIR]
        [--device cuda|cpu]

Parts, in the order they run (each at the JAX repo's defaults):
  roundtrip     python -m tpuvc_torch.quality.roundtrip_classes
  scale         python -m tpuvc_torch.quality.scale_validation --fresh
                (--n_train 50, 1500 streaming steps), then the same run
                continued to 5000 steps with cli.train --restore_from and
                scored with cli.evaluate SF1 -> TM3, recorded as
                ``quality_sf1_tm3_extended`` (how the JAX record's was made)
  scale_uncond  ``scale`` with the unconditioned critic: the architecture
                file with ``"d_conditional": false`` (the critic of the
                reference's scale validation, whose file predates the
                flag), its own run directory, recorded as
                ``scale_validation_uncond`` (config 2-4 times),
                ``quality_sf1_tm3_uncond`` (1500 steps) and
                ``quality_sf1_tm3_extended_uncond`` (5000 steps)
  scale_uncond_linear
                the same with the decoder's head linear too
                (``"output_activation": "linear"``): the whole
                architecture of the reference's scale validation, made
                before the package had a tanh head; keys with the suffix
                ``_uncond_linear``
  convergence   python -m tpuvc_torch.quality.convergence_ab --ab model
                --steps 10000 --eval_every 2500
  critic        python -m tpuvc_torch.quality.convergence_ab --ab critic
                --steps 10000 --eval_every 2500 (the ``uncond`` and ``cond``
                arms, recorded as ``critic_conditioning_ab``; on the corpus
                of ``scale``, whose analysis it reuses)
  tf32          python scripts/torch_tf32_quality.py (the VAW-GAN arm to
                5000 steps with cuDNN's TF32 off; after ``convergence``)

Every part writes into ``scale_validation_torch.json`` at the root of the
repository; after each, that file (and each convergence A/B's
``partial_results.json``, as ``partial_model.json`` / ``partial_critic.json``)
is copied into ``--out``, so a run cut short keeps the parts it finished.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import importlib.util
import os
import shutil
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpuvc_torch.cli import evaluate, train  # noqa: E402
from tpuvc_torch.quality import (common, convergence_ab,  # noqa: E402
                                 roundtrip_classes, scale_validation)
from tpuvc_torch.utils.config import Architecture  # noqa: E402

PARTS = ("roundtrip", "scale", "scale_uncond", "scale_uncond_linear",
         "convergence", "critic", "tf32")
SCALE_STEPS, EXTENDED_STEPS = 1500, 5000
# the scale validation's other architectures: the key suffix and the
# fields that differ from common.ARCH_PATH's
SCALE_VARIANTS = {
    "scale_uncond": ("uncond", {"d_conditional": False}),
    "scale_uncond_linear": ("uncond_linear", {"d_conditional": False,
                                              "output_activation": "linear"}),
}
# convergence_ab's arguments for the ``convergence`` and ``critic`` parts
CONVERGENCE_ARGS = ["--steps", "10000", "--eval_every", "2500"]
# each convergence A/B's run directories and partial results (in
# common.RUNS_DIR), by its --ab
CONV_LOGDIRS = {"model": "vcc10_conv", "critic": "vcc10_critic"}


def extend(device: str, logdir: str = "vcc10_logdir",
           key: str = "quality_sf1_tm3_extended") -> dict:
    """Continue the scale validation's run under ``logdir`` (in
    ``common.RUNS_DIR``) to EXTENDED_STEPS, score it and record it under
    ``key``."""
    root = os.path.join(common.RUNS_DIR, "vcc10")
    logdir = os.path.join(common.RUNS_DIR, logdir)
    run_dir = sorted(glob.glob(os.path.join(logdir, "train", "*")))[-1]
    t0 = time.perf_counter()
    train.main(["--corpus", root, "--logdir", logdir, "--restore_from",
                run_dir, "--architecture", common.ARCH_PATH, "--steps",
                str(EXTENDED_STEPS), "--no-tensorboard", "--device", device])
    train_s = round(time.perf_counter() - t0, 1)
    ev = evaluate.main(["--corpus", root, "--checkpoint", run_dir, "--src",
                        "SF1", "--trg", "TM3", "--device", device])
    rec = dict(ev, note=f"continued training from the {SCALE_STEPS}-step "
                        "checkpoint (cli.train --restore_from)",
               train_s=train_s)
    common.write_record(common.RECORD_PATH, {key: rec}, device)
    return rec


def scale(device: str) -> None:
    scale_validation.main(["--fresh", "--steps", str(SCALE_STEPS),
                           "--n_train", "50", "--device", device])
    extend(device)


def scale_variant(device: str, part: str) -> None:
    """``scale`` with ``common.ARCH_PATH``'s architecture changed as
    SCALE_VARIANTS[part] says, its keys suffixed beside ``scale``'s."""
    sfx, fields = SCALE_VARIANTS[part]
    path = os.path.join(common.RUNS_DIR, f"architecture-{sfx}.json")
    os.makedirs(common.RUNS_DIR, exist_ok=True)
    dataclasses.replace(Architecture.load(common.ARCH_PATH),
                        **fields).save(path)
    logdir = f"vcc10_logdir_{sfx}"
    saved = common.ARCH_PATH, common.RECORD_PATH
    common.ARCH_PATH = path
    # the study writes ``scale``'s keys: let it write elsewhere
    common.RECORD_PATH = os.path.join(common.RUNS_DIR, f"scale_{sfx}.json")
    try:
        rec = scale_validation.main([
            "--fresh", "--logdir", os.path.join(common.RUNS_DIR, logdir),
            "--steps", str(SCALE_STEPS), "--n_train", "50",
            "--device", device])
        common.RECORD_PATH = saved[1]
        quality = dict(rec.pop("quality_sf1_tm3"), **fields)
        common.write_record(common.RECORD_PATH, {
            f"scale_validation_{sfx}": dict(rec, **fields),
            f"quality_sf1_tm3_{sfx}": quality}, device)
        extend(device, logdir, f"quality_sf1_tm3_extended_{sfx}")
    finally:
        common.ARCH_PATH, common.RECORD_PATH = saved


def convergence(device: str, ab: str) -> None:
    convergence_ab.main(["--ab", ab, "--logdir", os.path.join(
        common.RUNS_DIR, CONV_LOGDIRS[ab])] + CONVERGENCE_ARGS
        + ["--device", device])


def copy_results(out: str) -> None:
    os.makedirs(out, exist_ok=True)
    if os.path.exists(common.RECORD_PATH):
        shutil.copy(common.RECORD_PATH, out)
    for ab, logdir in CONV_LOGDIRS.items():
        path = os.path.join(common.RUNS_DIR, logdir, "partial_results.json")
        if os.path.exists(path):
            shutil.copy(path, os.path.join(out, f"partial_{ab}.json"))


def tf32_script():
    path = os.path.join(ROOT, "scripts", "torch_tf32_quality.py")
    spec = importlib.util.spec_from_file_location("torch_tf32_quality", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("parts", nargs="+", choices=PARTS)
    p.add_argument("--out", default=None,
                   help="directory to copy the result files into after "
                        "each part")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = args.device
    runs = {
        "roundtrip": lambda: roundtrip_classes.main(["--device", dev]),
        "scale": lambda: scale(dev),
        **{part: (lambda part=part: scale_variant(dev, part))
           for part in SCALE_VARIANTS},
        "convergence": lambda: convergence(dev, "model"),
        "critic": lambda: convergence(dev, "critic"),
        "tf32": lambda: tf32_script().main(["--device", dev]),
    }
    stop = threading.Event()

    def mirror():
        # finished milestones reach --out while a long part still runs
        while not stop.wait(60):
            copy_results(args.out)

    if args.out:
        threading.Thread(target=mirror, daemon=True).start()
    try:
        for part in (q for q in PARTS if q in args.parts):
            t0 = time.perf_counter()
            runs[part]()
            print(f"[record] {part} took {time.perf_counter() - t0:.1f} s",
                  flush=True)
            if args.out:
                copy_results(args.out)
    finally:
        stop.set()


if __name__ == "__main__":
    main()
