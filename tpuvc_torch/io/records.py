"""Frame-record format, binary-compatible with the reference analyzer.

The port's own copy of ``tpuvc/io/records.py`` (numpy only): the bytes it
writes equal the JAX package's (``tests/test_torch_entry.py``).

The reference (``analyzer.py``, SURVEY.md SS2.1) writes one flat ``.bin`` file
per utterance: float32 frames of 1029 values each,
``[sp(513) | ap(513) | f0(1) | en(1) | speaker_label(1)]``, where ``sp`` is
the energy-normalized log10 spectral envelope and ``en`` the per-frame energy.
We keep that exact layout so corpora prepared by either implementation are
interchangeable.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpuvc_torch.dsp.constants import EPSILON, FEAT_DIM, RECORD_DIM, SP_DIM


@dataclasses.dataclass
class Features:
    """Per-utterance WORLD features (host-side numpy)."""

    sp: np.ndarray   # [n_frames, SP_DIM] normalized log10 spectral envelope
    ap: np.ndarray   # [n_frames, SP_DIM] aperiodicity (amplitude ratio, [0,1])
    f0: np.ndarray   # [n_frames] Hz, 0 for unvoiced
    en: np.ndarray   # [n_frames] pre-normalization frame energy (linear)
    label: int = 0   # speaker id


def energy_normalize_sp(sp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Reference analyzer's energy normalization + log10.

    ``en = sum(sp, axis=1, keepdims=True); sp <- log10(sp / en)``
    (reference analyzer.py:~L60-90 [reconstructed]; energy is stored as a
    feature so conversion can restore scale).
    """
    en = np.sum(sp + EPSILON, axis=1, keepdims=True)
    log_sp = np.log10((sp + EPSILON) / en)
    return log_sp, en.squeeze(-1)


def energy_denormalize_sp(log_sp: np.ndarray, en: np.ndarray) -> np.ndarray:
    """Inverse of :func:`energy_normalize_sp`: ``sp = 10**log_sp * en``."""
    return np.power(10.0, log_sp) * en[..., None]


def pack_records(feats: Features) -> np.ndarray:
    """Stack features into [n_frames, RECORD_DIM] float32 records."""
    n = feats.sp.shape[0]
    rec = np.empty((n, RECORD_DIM), dtype=np.float32)
    rec[:, :SP_DIM] = feats.sp
    rec[:, SP_DIM:2 * SP_DIM] = feats.ap
    rec[:, 2 * SP_DIM] = feats.f0
    rec[:, 2 * SP_DIM + 1] = feats.en
    rec[:, FEAT_DIM] = float(feats.label)
    return rec


def unpack_records(rec: np.ndarray) -> Features:
    """Inverse of :func:`pack_records`."""
    rec = rec.reshape(-1, RECORD_DIM)
    return Features(
        sp=rec[:, :SP_DIM].astype(np.float32),
        ap=rec[:, SP_DIM:2 * SP_DIM].astype(np.float32),
        f0=rec[:, 2 * SP_DIM].astype(np.float32),
        en=rec[:, 2 * SP_DIM + 1].astype(np.float32),
        label=int(rec[0, FEAT_DIM]) if rec.shape[0] else 0,
    )


def write_bin(path: str, feats: Features) -> None:
    pack_records(feats).tofile(path)


def read_bin(path: str) -> Features:
    raw = np.fromfile(path, dtype=np.float32)
    if raw.size % RECORD_DIM != 0:
        raise ValueError(
            f"{path}: size {raw.size} is not a multiple of "
            f"RECORD_DIM={RECORD_DIM}")
    return unpack_records(raw)
