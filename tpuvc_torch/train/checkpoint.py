"""Checkpoint save and restore with ``torch.save``.

Port of ``tpuvc/train/checkpoint.py``: the reference checkpoints every N
steps and restarts from the newest checkpoint of a run directory
(``--restore_from``).  A checkpoint is ``<directory>/<step>.pt`` holding a
training state's ``state_dict()`` (the modules, both optimizers and the
step); it is written to a temporary file that is then renamed, so a run
killed while saving never leaves a half-written newest checkpoint.  The
newest ``max_to_keep`` are kept.  Saves are synchronous, so ``wait`` has
nothing to wait for.

The JAX package's checkpoints are Orbax directories, which cannot be read
without JAX: the port neither reads nor writes them.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


def _steps(directory: str) -> list[int]:
    """The steps of the checkpoints in ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(directory)) if m)


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state) -> None:
        """Write ``state.state_dict()`` as the checkpoint of ``step``."""
        tmp = self._path(step) + ".tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, self._path(step))
        for old in _steps(self.directory)[:-self.max_to_keep]:
            os.remove(self._path(old))

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    @property
    def latest_step(self) -> int | None:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def restore_latest(self, state) -> int | None:
        """Load the newest checkpoint into ``state`` (its modules and
        optimizers stay on their device) and return its step; None when
        the directory holds none."""
        restored = latest_state_dict(self.directory)
        if restored is None:
            return None
        state.load_state_dict(restored[0])
        return restored[1]


def latest_state_dict(directory: str) -> tuple[dict, int] | None:
    """The newest checkpoint's state dict, on the host, and its step; None
    when ``directory`` holds none or does not exist (nothing is created)."""
    steps = _steps(directory)
    if not steps:
        return None
    # onto the host: a module or optimizer loading it copies each tensor to
    # its own device, and Adam's step counts stay on the host
    path = os.path.join(directory, f"{steps[-1]}.pt")
    return torch.load(path, map_location="cpu", weights_only=True), steps[-1]
