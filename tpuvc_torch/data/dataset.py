"""Frame dataset and epoch-shuffled batcher (the reference's input queue).

Port of ``tpuvc/data/dataset.py``.  Frames are i.i.d. samples: the
corpus' normalized-log-SP frames and speaker labels live in one host array,
and ``BatchStream`` emits epoch-shuffled minibatches from it.  The
permutations are numpy's, drawn from ``np.random.default_rng(seed)`` as on
the JAX side, and rows are gathered by the port's native threaded gather
(``tpuvc_torch/native``, as the JAX side gathers with its own), so both
packages emit the same batches for the same seed, after ``skip`` too.
Record files are read by the native reader unless memory-mapped.  Only
the sp and label columns of each record are kept; normalization happens
per minibatch, so no second full-corpus copy is made.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np

from tpuvc_torch import native
from tpuvc_torch.data.normalizer import Tanhize
from tpuvc_torch.dsp.constants import FEAT_DIM, RECORD_DIM, SP_DIM
from tpuvc_torch.io import corpus as corpus_io


@dataclasses.dataclass
class FrameDataset:
    """All (sp_frame, speaker) pairs of a corpus split, host-resident."""

    x: np.ndarray  # [n, SP_DIM] normalized-log-SP (pre-Tanhize)
    y: np.ndarray  # [n] int32 speaker ids

    @staticmethod
    def from_bin_dir(corpus_root: str, split: str = corpus_io.TRAIN_SPLIT,
                     mmap: bool = False) -> "FrameDataset":
        paths = corpus_io.list_bins(corpus_root, split)
        if not paths:
            raise FileNotFoundError(
                f"no .bin records under {corpus_root}/bin/{split}")
        xs, ys = [], []
        for p in paths:
            if mmap:
                raw = np.memmap(p, dtype=np.float32, mode="r")
            else:
                raw = native.read_f32_native(p)
                if raw is None:
                    raise OSError(f"{p}: cannot open the record file")
            if raw.size % RECORD_DIM != 0:
                raise ValueError(
                    f"{p}: {raw.size} floats is not a multiple of "
                    f"RECORD_DIM={RECORD_DIM} — truncated or corrupt record "
                    f"file")
            rec = raw.reshape(-1, RECORD_DIM)
            xs.append(np.asarray(rec[:, :SP_DIM], np.float32))
            ys.append(np.asarray(rec[:, FEAT_DIM], np.int32))
        return FrameDataset(x=np.concatenate(xs), y=np.concatenate(ys))

    def __len__(self) -> int:
        return self.x.shape[0]

    def fit_normalizer(self) -> Tanhize:
        return Tanhize.fit(self.x)

    def batches(self, batch_size: int, seed: int = 0, normalizer:
                Tanhize | None = None,
                drop_remainder: bool = True) -> "BatchStream":
        """Infinite epoch-shuffled minibatch stream (supports cheap skip)."""
        n = len(self)
        if n < batch_size:
            raise ValueError(
                f"corpus has {n} frames < batch_size {batch_size}; "
                "reduce batch_size or add data")
        return BatchStream(self, batch_size, seed, normalizer, drop_remainder)


class BatchStream:
    """Infinite epoch-shuffled minibatch iterator over a FrameDataset.

    ``skip(n)`` advances the stream by n batches without gathering data, so
    a trainer resumed from a checkpoint continues the input stream where it
    left off (the permutation sequence is a function of the seed, so the
    position is the stream's whole state).
    """

    def __init__(self, ds: FrameDataset, batch_size: int, seed: int,
                 normalizer: Tanhize | None, drop_remainder: bool):
        self._ds = ds
        self._bs = batch_size
        self._norm = normalizer
        self._rng = np.random.default_rng(seed)
        n = len(ds)
        self._end = n - n % batch_size if drop_remainder else n
        self._perm = self._rng.permutation(n)
        self._i = 0

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        return self

    def _advance_epoch(self) -> None:
        if self._i >= self._end:
            self._perm = self._rng.permutation(len(self._ds))
            self._i = 0

    def skip(self, n_batches: int) -> None:
        for _ in range(n_batches):
            self._advance_epoch()
            self._i += self._bs

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        self._advance_epoch()
        idx = self._perm[self._i:self._i + self._bs]
        self._i += self._bs
        xb = native.gather_rows(self._ds.x, idx)
        if self._norm is not None:
            xb = self._norm.forward(xb).astype(np.float32)
        return xb, self._ds.y[idx]
