"""Trainers driving the training steps (reference trainer/{vae,vawgan}.py).

Port of ``tpuvc/train/trainer.py``.  A trainer owns the training state, a
checkpointer with auto-resume and the metrics writer.  ``train`` feeds
host batches one step at a time; ``train_resident`` uploads the frame
table once and runs ``n_inner`` steps per call with minibatches drawn on
the device.  Metrics are read back to the host only at log points,
checkpoints are written at save points and at the end.  The default device
is the CUDA card; a trainer raises without one unless given
``device="cpu"``.

``mesh`` is the JAX trainer's data mesh in PyTorch's idiom: a
process-group mesh (``parallel.distributed.global_mesh``, one process per
card), the default whenever a process group is initialized.  Every process
then reads the same global batch stream (same seed, same ``skip`` on
resume) and steps on its rows of each batch (axis 0 of the generator's
batch, axis 1 of the critic's), the gradients averaged over the world
(``train/steps.py``); every process restores the checkpoint, only rank 0
writes checkpoints and metrics, and the logged metrics are the world's
mean.  A local mesh of several devices is refused: training takes one
process per card.

Stage spans (``utils/profiling.span``) split a profile of a step:
``train.input`` (the host batches and their copies to the device), the
updates' ``train.critic`` and ``train.generator`` (``train/steps.py``),
``train.log`` (the metrics and the spectrogram summaries) and
``train.save`` (the checkpoint).
"""

from __future__ import annotations

import itertools
import logging
import os
from typing import Any, Iterator

import numpy as np
import torch

from tpuvc_torch.parallel import distributed
from tpuvc_torch.parallel.mesh import local_rows
from tpuvc_torch.train import steps as steps_lib
from tpuvc_torch.train.checkpoint import Checkpointer
from tpuvc_torch.train.summaries import MetricsWriter
from tpuvc_torch.utils.config import Architecture
from tpuvc_torch.utils.device import resolve
from tpuvc_torch.utils.profiling import span


def _table_fingerprint(a: np.ndarray) -> tuple:
    """O(1) identity for a host frame table: object id + shape/dtype + a
    1024-element strided value probe.  Catches whole-table in-place
    mutation (realistic edits like re-normalization touch essentially
    every element) without hashing the full table.  A sparse in-place edit
    (a few rows of a huge table) can miss every probe: treat resident
    tables as immutable, or pass a new array after editing.  The id() is
    only sound while the caller's array stays alive; train_resident keeps
    a strong reference to it for that reason."""
    obj_id = id(a)
    a = np.asarray(a)
    flat = a.reshape(-1)
    idx = np.linspace(0, max(flat.size - 1, 0),
                      num=min(1024, flat.size)).astype(np.int64)
    return (obj_id, a.shape, str(a.dtype), flat[idx].tobytes())


def _trainer_mesh(mesh, device: torch.device):
    """The trainer's process-group mesh, or None for one device: ``mesh``
    when given, else the world's when a process group is initialized."""
    if mesh is None and torch.distributed.is_initialized():
        mesh = distributed.global_mesh(device.type)
    if mesh is None:
        return None
    if not mesh.is_process_group:
        if mesh.size > 1:
            raise ValueError(
                f"a local mesh of {mesh.size} devices cannot train: start "
                "one process per card (torchrun --nproc_per_node=N -m "
                "tpuvc_torch.cli.train ...) and pass "
                "parallel.distributed.global_mesh()")
        return None
    if mesh.devices[0].type != device.type:
        raise ValueError(f"the mesh's device {mesh.devices[0]} is not a "
                         f"{device.type} device")
    if mesh.size == 1:
        return None
    return mesh


class _BaseTrainer:
    def __init__(self, arch: Architecture, run_dir: str, seed: int = 0,
                 use_tensorboard: bool = True,
                 device: torch.device | str = "cuda", mesh=None):
        """``mesh``: a process-group mesh to train data parallel over (by
        default the world's when a process group is initialized); the
        trainer then runs on the mesh's device for this process."""
        device = resolve(device)
        self.mesh = _trainer_mesh(mesh, device)
        if self.mesh is not None:
            device = self.mesh.devices[0]
            if arch.training.batch_size % self.mesh.size:
                raise ValueError(
                    f"batch_size {arch.training.batch_size} does not divide "
                    f"over {self.mesh.size} processes")
        self.device = device
        self.arch = arch
        self.run_dir = run_dir
        self.seed = seed
        # rank 0 writes the checkpoints and the metrics; every rank reads
        self.lead = self.mesh is None or self.mesh.rank == 0
        self.writer = (MetricsWriter(os.path.join(run_dir, "events"),
                                     use_tensorboard=use_tensorboard)
                       if self.lead else None)
        self.ckpt = Checkpointer(os.path.join(run_dir, "ckpt"))
        self.state: Any = None
        # the device copy of the resident table, keyed by the host arrays'
        # identity plus a content probe (identity alone misses an in-place
        # edit of the same array, which would leave the copy stale)
        self._resident_key: Any = None
        self._resident_src: Any = None   # strong refs: keep id() sound
        self._resident_dev: Any = None

    @property
    def model(self):
        """The generator: encoder + decoder."""
        raise NotImplementedError

    def _resume(self, batches: Iterator | None = None,
                batches_per_step: int = 1) -> int:
        step = self.ckpt.restore_latest(self.state) or 0
        if step and batches is not None:
            # continue the input stream where the checkpoint left off;
            # BatchStream.skip advances without gathering, other
            # iterators are drained
            n = step * batches_per_step
            if hasattr(batches, "skip"):
                batches.skip(n)
            else:
                next(itertools.islice(batches, n - 1, n), None)
        return step

    def _to_device(self, x, y, batch_axis: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """This process's rows of a host batch, on its device."""
        mine = (slice(None),) * batch_axis + (
            local_rows(self.mesh, np.shape(x)[batch_axis]),)
        return (torch.as_tensor(x[mine], dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(y[mine], device=self.device).long())

    @property
    def group(self):
        return None if self.mesh is None else self.mesh.group

    def _log(self, step: int, m: dict[str, torch.Tensor]) -> dict[str, float]:
        """The metrics on the host, the world's mean on a mesh, written by
        rank 0."""
        if self.mesh is not None:
            vals = steps_lib.all_reduce_mean(
                [v.reshape(1).float() for v in m.values()], self.group)
            m = dict(zip(m, vals))
        metrics = {k: float(v) for k, v in m.items()}
        if self.lead:
            self.writer.scalars(step, metrics)
        return metrics

    def _save(self, step: int) -> None:
        if self.lead:
            with span("train.save"):
                self.ckpt.save(step, self.state)

    def _log_spectrograms(self, step: int, x, y) -> None:
        """Real vs reconstructed frames as images (reference util/image.py
        tf.summary.image thumbnails): one forward without gradients, on
        rank 0."""
        if not self.lead:
            return
        try:
            x = torch.as_tensor(x[:64], dtype=torch.float32,
                                device=self.device)
            y = torch.as_tensor(y[:64], device=self.device).long()
            g = torch.Generator(device=self.device).manual_seed(0)
            with torch.no_grad():
                xh = self.model(x, y, steps_lib.vae_noise(
                    g, x.shape[0], self.arch))["xh"]
            self.writer.spectrogram(step, "x_real", x.cpu().numpy(),
                                    log_input=False)
            self.writer.spectrogram(step, "x_recon", xh.cpu().numpy(),
                                    log_input=False)
        except Exception:
            # summaries must never take down training, but a silent
            # failure would hide forever: warn once per run
            if not getattr(self, "_spectrogram_warned", False):
                self._spectrogram_warned = True
                logging.getLogger(__name__).warning(
                    "spectrogram summaries failed at step %d; suppressing "
                    "further attempts' errors", step, exc_info=True)

    def close(self):
        self.ckpt.wait()
        if self.writer is not None:
            self.writer.close()

    def _multistep(self, data: torch.Tensor, labels: torch.Tensor,
                   n_inner: int) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def train_resident(self, data: np.ndarray, labels: np.ndarray,
                       total_steps: int, n_inner: int = 50,
                       log_every: int | None = None,
                       save_every: int | None = None) -> dict[str, float]:
        """Device-resident path: upload the frame table once, run n_inner
        optimizer steps per call (train/steps.py ``*_multistep``) with
        minibatches drawn on the device, uniform with replacement.
        Checkpoints and metrics land on call boundaries."""
        t = self.arch.training
        log_every = max(1, (log_every or t.summary_freq) // n_inner)
        save_every = max(1, (save_every or t.save_freq) // n_inner)
        start = self._resume()
        remaining = max(0, int(total_steps) - start)
        if remaining == 0:
            # already at (or past) total_steps: run no step, as the
            # per-step trainer does
            self.ckpt.wait()
            return {}
        key = (_table_fingerprint(data), _table_fingerprint(labels))
        if self._resident_key != key:
            self._resident_key = key
            self._resident_src = (data, labels)
            # copies (on the CPU too: no view of the caller's array)
            self._resident_dev = (
                torch.tensor(data, dtype=torch.float32, device=self.device),
                torch.tensor(labels, dtype=torch.long, device=self.device))
        data_d, labels_d = self._resident_dev
        # full n_inner calls plus one short remainder call, so the last
        # checkpoint lands exactly on total_steps
        n_full, rem = divmod(remaining, n_inner)
        plan = [n_inner] * n_full + ([rem] if rem else [])
        metrics = {}
        for d, n in enumerate(plan):
            m = self._multistep(data_d, labels_d, n)
            step = self.state.step
            last = d + 1 == len(plan)
            if (d + 1) % log_every == 0 or last:
                with span("train.log"):
                    metrics = self._log(step, m)
            if (d + 1) % save_every == 0 or last:
                # the reference's one visual, at save boundaries only: a
                # fixed slice of the table, one forward
                with span("train.log"):
                    self._log_spectrograms(step, data[:64], labels[:64])
                self._save(step)
        self.ckpt.wait()
        return metrics


class VAETrainer(_BaseTrainer):
    """Plain conditional-VAE training (reference VAETrainer)."""

    def __init__(self, arch: Architecture, run_dir: str, **kw):
        super().__init__(arch, run_dir, **kw)
        self.state = steps_lib.init_vae_state(arch, self.seed, self.device)

    @property
    def model(self):
        return self.state.model

    def _multistep(self, data, labels, n_inner):
        return steps_lib.vae_multistep(self.state, data, labels, n_inner,
                                       self.seed, self.mesh)

    def train(self, batches: Iterator[tuple[np.ndarray, np.ndarray]],
              total_steps: int, log_every: int | None = None,
              save_every: int | None = None) -> dict[str, float]:
        t = self.arch.training
        log_every = log_every or t.summary_freq
        save_every = save_every or t.save_freq
        start = self._resume(batches, batches_per_step=1)
        metrics = {}
        for step in range(start, total_steps):
            with span("train.input"):
                xb, yb = next(batches)
                x, y = self._to_device(xb, yb)
            g = steps_lib.step_generator(self.seed, step, self.device)
            eps = steps_lib.vae_noise(g, len(xb), self.arch)
            m = steps_lib.vae_step(self.state, x, y,
                                   eps[local_rows(self.mesh, len(xb))],
                                   self.group)
            if (step + 1) % log_every == 0 or step + 1 == total_steps:
                with span("train.log"):
                    metrics = self._log(step + 1, m)
                    self._log_spectrograms(step + 1, xb, yb)
            if (step + 1) % save_every == 0 or step + 1 == total_steps:
                self._save(step + 1)
        self.ckpt.wait()
        return metrics


class VAWGANTrainer(_BaseTrainer):
    """VAE + Wasserstein critic with n_unroll critic updates per generator
    update (reference VAWGANTrainer)."""

    def __init__(self, arch: Architecture, run_dir: str, **kw):
        super().__init__(arch, run_dir, **kw)
        self.state = steps_lib.init_vawgan_state(arch, self.seed,
                                                 self.device)

    @property
    def model(self):
        return self.state.gen

    def _multistep(self, data, labels, n_inner):
        return steps_lib.vawgan_multistep(self.state, data, labels, n_inner,
                                          self.seed, self.mesh)

    def train(self, batches: Iterator[tuple[np.ndarray, np.ndarray]],
              total_steps: int, log_every: int | None = None,
              save_every: int | None = None) -> dict[str, float]:
        t = self.arch.training
        n_unroll = t.n_unroll
        log_every = log_every or t.summary_freq
        save_every = save_every or t.save_freq
        start = self._resume(batches, batches_per_step=n_unroll + 1)
        metrics = {}
        for step in range(start, total_steps):
            with span("train.input"):
                xs, ys = zip(*(next(batches) for _ in range(n_unroll + 1)))
                x_crit, y_crit = self._to_device(np.stack(xs[:-1]),
                                                 np.stack(ys[:-1]), 1)
                x_gen, y_gen = self._to_device(xs[-1], ys[-1])
            g = steps_lib.step_generator(self.seed, step, self.device)
            b = len(xs[-1])
            noise = steps_lib.vawgan_noise(g, b, self.arch)
            m = steps_lib.vawgan_step(
                self.state, x_crit, y_crit, x_gen, y_gen,
                noise.rows(local_rows(self.mesh, b)), self.group)
            if (step + 1) % log_every == 0 or step + 1 == total_steps:
                with span("train.log"):
                    metrics = self._log(step + 1, m)
                    self._log_spectrograms(step + 1, xs[-1], ys[-1])
            if (step + 1) % save_every == 0 or step + 1 == total_steps:
                self._save(step + 1)
        self.ckpt.wait()
        return metrics


TRAINERS = {"VAETrainer": VAETrainer, "VAWGANTrainer": VAWGANTrainer}


def make_trainer(arch: Architecture, run_dir: str, **kw) -> _BaseTrainer:
    try:
        cls = TRAINERS[arch.trainer]
    except KeyError as e:
        raise KeyError(f"unknown trainer {arch.trainer!r}; "
                       f"known: {sorted(TRAINERS)}") from e
    return cls(arch, run_dir, **kw)
