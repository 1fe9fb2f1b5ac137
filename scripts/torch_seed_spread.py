"""How far the VAW-GAN's quality trajectory moves with the training draws.

    python scripts/torch_seed_spread.py [--seeds 1,2,3] [--steps 5000]
        [--eval_every 2500] [--n_inner 100] [--root DIR] [--logdir DIR]
        [--device cuda|cpu]

Trains ``tpuvc_torch.quality.convergence_ab``'s VAW-GAN arm of the
``model`` A/B on the same corpus (``--root``, the study's default) and
milestones from other trainer seeds (the seed sets the initial parameters
and every minibatch and noise draw; the study's own run is seed 0), and
writes each trajectory into ``scale_validation_torch.json`` under
``convergence_ab_seeds`` (``models``: ``seed<N>``).  With several seeds the
corpus is prepared once and each seed trains in a process of its own, all
at once on the one card; their wall times then share it.  An investigation
script: the studies train from seed 0, as the JAX scripts do.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpuvc_torch.cli.common import apply_device  # noqa: E402
from tpuvc_torch.quality import common, convergence_ab  # noqa: E402
from tpuvc_torch.utils.config import Architecture  # noqa: E402

KEY = "convergence_ab_seeds"


def record(seed: int, traj: list[dict], args, device) -> None:
    """Merge one seed's trajectory into the record under a file lock (the
    seeds' processes finish in any order)."""
    with open(common.RECORD_PATH + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        entry = common.read_record(common.RECORD_PATH).get(KEY, {
            "steps": args.steps, "eval_every": args.eval_every,
            "ab": "model", "style": args.style, "models": {}})
        entry["models"][f"seed{seed}"] = traj
        common.write_record(common.RECORD_PATH, {KEY: entry}, device)


def main(argv: list[str] | None = None) -> dict:
    p = convergence_ab.parser(__doc__)
    p.set_defaults(steps=5000, eval_every=2500,
                   logdir=os.path.join(common.RUNS_DIR, "vcc10_seeds"))
    p.add_argument("--seeds", default="1,2,3")
    args = p.parse_args(argv)
    device = apply_device(args)
    seeds = [int(s) for s in args.seeds.split(",")]
    if len(seeds) > 1:
        convergence_ab.prepare(args)
        common_args = ["--root", args.root, "--steps", str(args.steps),
                       "--eval_every", str(args.eval_every), "--n_inner",
                       str(args.n_inner), "--n_train", str(args.n_train),
                       "--style", args.style, "--device", args.device]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *common_args,
             "--logdir", os.path.join(args.logdir, f"seed{s}"),
             "--seeds", str(s)]) for s in seeds]
        failed = [s for s, proc in zip(seeds, procs) if proc.wait() != 0]
        if failed:
            raise RuntimeError(f"seeds {failed} failed")
        return common.read_record(common.RECORD_PATH)[KEY]

    name, overrides = convergence_ab.arms("model")[0]
    arch = convergence_ab.arm_architecture(
        Architecture.load(common.ARCH_PATH), overrides)
    common.start_launches(device)
    data, labels = convergence_ab.prepare(args)
    traj = convergence_ab.train_arm(name, arch, data, labels, args, device,
                                    seed=seeds[0])
    common.require_analysis_launches(device, "torch_seed_spread")
    record(seeds[0], traj, args, device)
    print({f"seed{seeds[0]}": traj}, flush=True)
    return traj


if __name__ == "__main__":
    main()
