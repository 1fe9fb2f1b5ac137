"""The port's trained-quality record on the card, study by study.

    python scripts/torch_quality_record.py PART [PART ...] [--out DIR]
        [--device cuda|cpu]

Parts, in the order they run (each at the JAX repo's defaults):
  roundtrip    python -m tpuvc_torch.quality.roundtrip_classes
  scale        python -m tpuvc_torch.quality.scale_validation --fresh
               (--n_train 50, 1500 streaming steps), then the same run
               continued to 5000 steps with cli.train --restore_from and
               scored with cli.evaluate SF1 -> TM3, recorded as
               ``quality_sf1_tm3_extended`` (how the JAX record's was made)
  convergence  python -m tpuvc_torch.quality.convergence_ab --ab model
               --steps 10000 --eval_every 2500
  tf32         python scripts/torch_tf32_quality.py (the VAW-GAN arm to
               5000 steps with cuDNN's TF32 off; after ``convergence``)

Every part writes into ``scale_validation_torch.json`` at the root of the
repository; after each, that file (and the convergence study's
``partial_results.json``) is copied into ``--out``, so a run cut short
keeps the parts it finished.
"""

from __future__ import annotations

import argparse
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

PARTS = ("roundtrip", "scale", "convergence", "tf32")
SCALE_STEPS, EXTENDED_STEPS = 1500, 5000


def extend(device: str) -> dict:
    """Continue scale_validation's run to EXTENDED_STEPS and score it."""
    root = os.path.join(common.RUNS_DIR, "vcc10")
    logdir = os.path.join(common.RUNS_DIR, "vcc10_logdir")
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
    common.write_record(common.RECORD_PATH,
                        {"quality_sf1_tm3_extended": rec}, device)
    return rec


def copy_results(out: str) -> None:
    os.makedirs(out, exist_ok=True)
    for path in (common.RECORD_PATH, os.path.join(
            common.RUNS_DIR, "vcc10_conv", "partial_results.json")):
        if os.path.exists(path):
            shutil.copy(path, out)


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
    dev = ["--device", args.device]
    runs = {
        "roundtrip": lambda: roundtrip_classes.main(dev),
        "scale": lambda: (scale_validation.main(
            ["--fresh", "--steps", str(SCALE_STEPS), "--n_train", "50"]
            + dev), extend(args.device)),
        "convergence": lambda: convergence_ab.main(
            ["--ab", "model", "--steps", "10000", "--eval_every", "2500"]
            + dev),
        "tf32": lambda: tf32_script().main(dev),
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
