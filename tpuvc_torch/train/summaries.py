"""Metrics sink of the trainers (the reference's tf.summary + TensorBoard).

Port of ``tpuvc/train/summaries.py``: always a plain ``metrics.jsonl`` (one
record per log point: step, wall time and the scalars), and a TensorBoard
event file besides when ``torch.utils.tensorboard`` imports.  That import
needs the ``tensorboard`` package, which a machine may lack; it is made
only when a writer with TensorBoard is created, so importing this module
never needs it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

import numpy as np

from tpuvc_torch.utils.image import spectrogram_image


def _tb_writer(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir)


class MetricsWriter:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = _tb_writer(logdir) if use_tensorboard else None

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            rec[k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(k, float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def spectrogram(self, step: int, tag: str, frames: np.ndarray,
                    log_input: bool = True) -> None:
        if self._tb is not None:
            img = spectrogram_image(np.asarray(frames), log_input=log_input)
            self._tb.add_image(tag, img, step, dataformats="HWC")

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
