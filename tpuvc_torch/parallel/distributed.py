"""The process group of data-parallel training.

Port of ``tpuvc/parallel/distributed.py`` on ``torch.distributed``.  The
JAX package joins hosts with ``jax.distributed.initialize``; here every
card gets a process of its own (``torchrun --nproc_per_node=N -m
tpuvc_torch.cli.train ...``), and the processes find each other through
the environment:

- the JAX side's names: ``COORDINATOR_ADDRESS`` (host:port),
  ``NUM_PROCESSES`` and ``PROCESS_ID`` (``JAX_``-prefixed variants
  accepted);
- else torchrun's: ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``.

Each process takes the card ``LOCAL_RANK`` (its rank where that is unset)
modulo the cards it sees, so ranks beyond the cards of a machine share
them; NCCL refuses two ranks on one card, so such a world needs
``backend="gloo"``, which all-reduces CUDA tensors through the host.
Nothing happens at import time.
"""

from __future__ import annotations

import os

import torch

from tpuvc_torch.parallel.mesh import DataMesh, make_mesh
from tpuvc_torch.utils.device import resolve


def _env(name: str) -> str | None:
    return os.environ.get(name) or os.environ.get("JAX_" + name)


def _world() -> tuple[str, int, int] | None:
    """(init method, world size, rank) from the environment, or None when
    no cluster is configured."""
    addr = _env("COORDINATOR_ADDRESS")
    if addr:
        nproc, pid = _env("NUM_PROCESSES"), _env("PROCESS_ID")
        if nproc is None or pid is None:
            raise ValueError("COORDINATOR_ADDRESS is set without "
                             "NUM_PROCESSES and PROCESS_ID")
        return f"tcp://{addr}", int(nproc), int(pid)
    env = os.environ
    if env.get("MASTER_ADDR") and "WORLD_SIZE" in env and "RANK" in env:
        return (f"tcp://{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}",
                int(env["WORLD_SIZE"]), int(env["RANK"]))
    return None


def local_rank() -> int:
    """This process's index among the processes of its machine:
    ``LOCAL_RANK``, else its rank in the world (one machine), else 0."""
    rank = (os.environ.get("LOCAL_RANK") or _env("PROCESS_ID")
            or os.environ.get("RANK"))
    return int(rank) if rank is not None else 0


def ensure_initialized(backend: str | None = None) -> bool:
    """Join the process group the environment describes, once; returns
    whether the world has more than one process (False, and nothing done,
    when no cluster is configured).  ``backend`` defaults to ``nccl`` where
    there is a card and ``gloo`` otherwise."""
    dist = torch.distributed
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = _world()
    if world is None:
        return False
    init_method, size, rank = world
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(
        backend or ("nccl" if torch.cuda.is_available() else "gloo"),
        init_method=init_method, world_size=size, rank=rank)
    return size > 1


def global_mesh(device: torch.device | str = "cuda") -> DataMesh:
    """The process-group mesh: every process of the world, each on its own
    device of the type ``device`` names (its card ``LOCAL_RANK`` modulo the
    cards present, or the CPU).  Without a configured cluster, a local mesh
    of this process's one device."""
    ensure_initialized()
    dev = resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    dist = torch.distributed
    if not dist.is_initialized():
        return make_mesh(devices=[dev])
    return DataMesh((dev,), group=dist.group.WORLD, rank=dist.get_rank())
