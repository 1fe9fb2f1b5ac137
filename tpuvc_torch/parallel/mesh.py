"""A 1-D data mesh of devices, and the helpers that split a batch over it.

Port of ``tpuvc/parallel/mesh.py`` in PyTorch's idiom.  The JAX mesh is one
program over every device (XLA's single-controller SPMD); here there are
two kinds of mesh:

- a **local mesh** (``make_mesh``): the ordered devices of this process.
  Serving runs over it in one process: one model replica per device, one
  shard of each chunk per device, each shard dispatched from a thread of
  its own (``run_shards``), so that the host-bound analysis of one shard
  overlaps the others.  A device may appear more than once: that is a
  virtual mesh, whose shards share their device (and its replica).  The
  CPU tests use 8 x ``cpu`` (the counterpart of the JAX tests'
  ``--xla_force_host_platform_device_count=8`` CPU mesh); on a machine with
  one card ``chip_smoke.py`` uses 2 x ``cuda:0``, so that the sharding,
  the dispatch and the gather run for real.
- a **process-group mesh** (``parallel/distributed.py:global_mesh``): one
  process per card under ``torch.distributed``, each holding one device;
  ``group`` is the process group and ``rank`` this process's place in it.
  Training runs over it, its gradients all-reduced by hand.

Parameters are replicated (``replicated``); batches are split along one
axis into contiguous, equal shards (``shard_batch``).  The JAX mesh's
second, size-1 ``model`` axis has no counterpart: nothing is sharded by
model.
"""

from __future__ import annotations

import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from tpuvc_torch.utils.device import resolve

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The ordered devices of a data mesh.  For a process-group mesh,
    ``devices`` holds this process's own device, ``group`` the
    ``torch.distributed`` process group and ``rank`` this process's rank
    in it."""

    devices: tuple[torch.device, ...]
    group: Any = None
    rank: int = 0

    @property
    def size(self) -> int:
        """The number of shards a batch is split into."""
        if self.group is None:
            return len(self.devices)
        return torch.distributed.get_world_size(self.group)

    @property
    def is_process_group(self) -> bool:
        return self.group is not None


def make_mesh(n_devices: int | None = None,
              devices: list | None = None) -> DataMesh:
    """A local mesh over the first ``n_devices`` of ``devices`` (default:
    every CUDA card, ``torch.cuda.device_count()`` of them).  Raises
    without a card unless ``devices`` names CPU devices, and on
    ``n_devices`` above what ``devices`` holds."""
    if devices is None:
        resolve("cuda")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [_indexed(resolve(d)) for d in devices]
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return DataMesh(tuple(devs[:n]))


def _indexed(d: torch.device) -> torch.device:
    """A CUDA device with its index ("cuda" is the current card), so that
    equal devices compare equal."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def local_rows(mesh: DataMesh | None, n: int) -> slice:
    """The rows of an ``n``-row batch that this process holds: all of them
    without a mesh or on a local mesh, its rank's contiguous share on a
    process-group mesh.  Raises when ``n`` does not divide."""
    if mesh is None or not mesh.is_process_group:
        return slice(0, n)
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not divide over "
                         f"{mesh.size} processes")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(mesh: DataMesh, *arrays, batch_axis: int = 0):
    """Split each array (numpy or tensor) along ``batch_axis`` into one
    contiguous shard per device of a local mesh, on that device: a list of
    shards per array, a tuple of such lists for several arrays.  Raises
    when the axis does not divide.  (A process-group mesh's process takes
    its rows with ``local_rows``.)"""
    out = []
    for a in arrays:
        t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        n = t.shape[batch_axis]
        if n % mesh.size:
            raise ValueError(f"axis {batch_axis} of length {n} does not "
                             f"divide over a mesh of {mesh.size}")
        k = n // mesh.size
        out.append([t.narrow(batch_axis, i * k, k).to(d)
                    for i, d in enumerate(mesh.devices)])
    return tuple(out) if len(out) > 1 else out[0]


def replicated(mesh: DataMesh, module_or_tensor):
    """One copy of a module or tensor per distinct device of the mesh, as a
    list aligned with ``mesh.devices``: a repeated device shares its copy,
    and a device that already holds the original gets the original."""
    copies: dict[torch.device, Any] = {}
    for d in mesh.devices:
        if d in copies:
            continue
        if torch.is_tensor(module_or_tensor):
            copies[d] = module_or_tensor.to(d)
        elif _device_of(module_or_tensor) == d:
            copies[d] = module_or_tensor
        else:
            copies[d] = copy.deepcopy(module_or_tensor).to(d)
    return [copies[d] for d in mesh.devices]


def _device_of(module: torch.nn.Module) -> torch.device | None:
    p = next(module.parameters(), None)
    return None if p is None else p.device


def run_shards(mesh: DataMesh, fn: Callable[[int, torch.device], Any]
               ) -> list:
    """``fn(i, device)`` for every shard ``i`` of a local mesh, each in a
    thread of its own with its device current; the results in shard order.
    The threads share the interpreter lock, so they overlap where the work
    waits on a device or runs native code.  Kernels go to each device's
    current stream (shards on one device run one after the other there).
    Each thread takes the caller's intra-op thread count (OpenMP's is per
    thread, and a new thread would take one per core: a reduction would
    then split otherwise than in the caller).  Every shard's exception is
    read; the first is raised."""
    n_threads = torch.get_num_threads()

    def one(i: int):
        torch.set_num_threads(n_threads)
        d = mesh.devices[i]
        if d.type == "cuda":
            with torch.cuda.device(d):
                return fn(i, d)
        return fn(i, d)

    if mesh.size == 1:
        return [one(0)]
    with ThreadPoolExecutor(max_workers=mesh.size) as pool:
        futures = [pool.submit(one, i) for i in range(mesh.size)]
        errors = [f.exception() for f in futures]
    for e in errors:
        if e is not None:
            raise e
    return [f.result() for f in futures]
