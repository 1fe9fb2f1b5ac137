"""Training CLI (the reference's ``python main.py``).

  python -m tpuvc_torch.cli.train --model VAWGAN --trainer VAWGANTrainer \
      --architecture configs/architecture-vawgan-vcc2016.json \
      --corpus dataset/vcc2016 [--logdir logdir] [--restore_from DIR] \
      [--steps N] [--msg "note"] [--resident N] [--device cuda|cpu]

Port of ``tpuvc/cli/train.py`` with the same flags, ``--device`` in place
of ``--platform``: training runs on the CUDA card unless ``--device``
names another.  The run directory gets ``architecture.json``, the
checkpoints (``ckpt/<step>.pt``) and ``events/metrics.jsonl``; a run
started with ``--restore_from`` resumes from its newest checkpoint.
Training takes the default route (the fused-kernel switches are refused).

Data parallel over N cards: ``torchrun --nproc_per_node=N -m
tpuvc_torch.cli.train ...`` (or the JAX side's ``COORDINATOR_ADDRESS`` /
``NUM_PROCESSES`` / ``PROCESS_ID``).  Every process trains on its share of
each global batch of ``batch_size`` rows; rank 0 makes the run directory
and writes the checkpoints, the metrics and the corpus' normaliser.  As in
the JAX CLI, there is no flag for it: the environment decides.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from tpuvc_torch.cli.common import add_device_flag, apply_device


def main(argv: list[str] | None = None) -> str:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--architecture",
                   default="configs/architecture-vawgan-vcc2016.json")
    p.add_argument("--model", default=None,
                   help="override the architecture's model (VAE | VAWGAN)")
    p.add_argument("--trainer", default=None,
                   help="override trainer (VAETrainer | VAWGANTrainer)")
    p.add_argument("--corpus", required=True)
    p.add_argument("--logdir", default="logdir")
    p.add_argument("--restore_from", default=None)
    p.add_argument("--msg", default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="total optimizer steps (default: epochs * "
                        "frames-per-epoch / batch)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-tensorboard", action="store_true")
    p.add_argument("--debug_nans", action="store_true",
                   help="fail fast on NaNs (autograd's anomaly mode)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the run into the "
                        "run dir (profile/trace.json)")
    p.add_argument("--resident", type=int, default=0, metavar="N",
                   help="device-resident path: upload the frame table to "
                        "the device once and run N optimizer steps per "
                        "call, minibatches drawn on the device (uniform "
                        "with replacement).  0 = the epoch-exact streaming "
                        "trainer (default)")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = apply_device(args)

    import torch

    from tpuvc_torch.parallel import distributed
    mesh = None
    if distributed.ensure_initialized(
            backend="gloo" if device.type == "cpu" else None):
        mesh = distributed.global_mesh(device.type)
    lead = mesh is None or mesh.rank == 0

    if args.debug_nans:
        from tpuvc_torch.utils.profiling import enable_debug_checks
        enable_debug_checks()

    from tpuvc_torch.data.dataset import FrameDataset
    from tpuvc_torch.data.normalizer import Tanhize
    from tpuvc_torch.train.trainer import make_trainer
    from tpuvc_torch.utils.config import Architecture
    from tpuvc_torch.utils.logdir import make_run_dir
    from tpuvc_torch.utils.profiling import trace

    arch = Architecture.load(args.architecture)
    overrides = {}
    if args.model:
        overrides["model"] = args.model
    if args.trainer:
        overrides["trainer"] = args.trainer
    if overrides:
        arch = dataclasses.replace(arch, **overrides)

    ds = FrameDataset.from_bin_dir(args.corpus)
    etc = os.path.join(args.corpus, "etc")
    run_dir = None
    if lead:
        run_dir = make_run_dir(args.logdir, args.restore_from, args.msg)
        arch.save(os.path.join(run_dir, "architecture.json"))
        try:
            Tanhize.from_etc(etc)
        except FileNotFoundError:
            ds.fit_normalizer().save(etc)
    if mesh is not None:
        # rank 0's run directory, once its files are written
        shared = [run_dir]
        torch.distributed.broadcast_object_list(shared, src=0,
                                                group=mesh.group)
        run_dir = shared[0]
    norm = Tanhize.from_etc(etc)
    t = arch.training
    steps = args.steps or max(1, t.epoch * t.num_frames_per_epoch
                              // t.batch_size)
    trainer = make_trainer(arch, run_dir, seed=args.seed,
                           use_tensorboard=not args.no_tensorboard,
                           device=device, mesh=mesh)
    if lead:
        print(f"[train] {arch.model}/{arch.trainer} run_dir={run_dir} "
              f"frames={len(ds)} steps={steps}"
              + (f" processes={mesh.size}" if mesh else ""))
    with trace(os.path.join(run_dir, "profile")
               if args.profile and lead else None):
        if args.resident:
            metrics = trainer.train_resident(norm.forward(ds.x), ds.y, steps,
                                             n_inner=args.resident)
        else:
            metrics = trainer.train(
                ds.batches(t.batch_size, seed=args.seed, normalizer=norm),
                steps)
    trainer.close()
    if lead:
        print(f"[train] final metrics: "
              f"{ {k: round(v, 4) for k, v in metrics.items()} }")
    return run_dir


if __name__ == "__main__":
    main()
