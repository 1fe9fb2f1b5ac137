"""Deterministic epoch-shuffled batches over a random-access frame source.

The port's counterpart of ``tpuvc/data/grain_pipeline.py``, without Grain
(the card's machine has none): ``grain_batches`` yields the batches that
the JAX function's ``grain.DataLoader`` yields, in the same order, for a
larger-than-memory or memory-mapped corpus or when the input stream must
resume exactly mid-epoch (``skip``).  Normalization happens per item, so
a memory-mapped ``FrameDataset`` is never copied whole.

Grain's order (``IndexSampler(shuffle=True)`` + ``Batch(drop_remainder=
True)``, grain 0.2.15): record ``index_shuffle(i, n - 1, (seed + e) mod
2**32, rounds=4)`` comes at position ``i`` of epoch ``e``, and batches
run across epoch boundaries (100 records in batches of 40 over 2 epochs
are 5 batches).  ``index_shuffle`` is Grain's compiled one
(``grain/_src/python/experimental/index_shuffle``): a Simon-style Feistel
cipher on a block of ``max(16, ceil(log2(max_index)) rounded up to even)``
bits whose 4 round keys are ``std::seed_seq{seed}.generate``'s
words, walked in cycles until it lands in ``[0, max_index]``.  It is
reproduced here in numpy for a whole epoch at once, quirk included: where
``max_index`` is an even power of two the block is one bit short, so an
epoch of ``4**k + 1`` records is not a permutation (record 0 comes twice
and record ``4**k`` never), in Grain as here.
"""

from __future__ import annotations

import math
from collections.abc import Iterator

import numpy as np

from tpuvc_torch.data.dataset import FrameDataset
from tpuvc_torch.data.normalizer import Tanhize

ROUNDS = 4
MIN_BLOCK_BITS = 16
_M32 = 0xFFFFFFFF


def _seed_seq(seed: int, n: int) -> list[int]:
    """``std::seed_seq{seed}.generate`` of ``n`` 32-bit words (the C++
    standard's algorithm, [rand.util.seedseq])."""
    b = [0x8B8B8B8B] * n
    t = (11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39
         else 3 if n >= 7 else (n - 1) // 2)
    p = (n - t) // 2
    q = p + t
    m = max(2, n)   # max(s + 1, n) with one seed word

    def mix(x: int) -> int:
        return x ^ (x >> 27)

    for k in range(m):
        r1 = 1664525 * mix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n]) & _M32
        r2 = (r1 + (1 if k == 0 else k % n + seed if k == 1 else k % n)
              ) & _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = 1566083941 * mix(
            (b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _M32) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def _encrypt(v: np.ndarray, keys: list[int], half: int) -> np.ndarray:
    """One pass of the Feistel cipher on ``2 * half``-bit blocks: halves
    (x, y) = (high, low); per key pair x ^= f(y) ^ k0, y ^= f(x) ^ k1 with
    f(a) = (rotl(a, 1) & rotl(a, 8)) ^ rotl(a, 2) on ``half`` bits."""
    mask = np.uint64((1 << half) - 1)

    def rotl(a, s):
        s %= half
        if s == 0:
            return a
        return ((a << np.uint64(s)) | (a >> np.uint64(half - s))) & mask

    def f(a):
        return (rotl(a, 1) & rotl(a, 8)) ^ rotl(a, 2)

    x = (v >> np.uint64(half)) & mask
    y = v & mask
    for k0, k1 in zip(keys[0::2], keys[1::2]):
        x = x ^ f(y) ^ (np.uint64(k0) & mask)
        y = y ^ f(x) ^ (np.uint64(k1) & mask)
    return (x << np.uint64(half)) | y


def index_shuffle(index: np.ndarray, max_index: int,
                  seed: int) -> np.ndarray:
    """Grain's compiled ``index_shuffle(i, max_index, seed, rounds=4)`` of
    every element ``i`` of ``index`` (each in ``[0, max_index]``), as
    int64."""
    index = np.asarray(index, np.int64)
    if max_index == 0:
        return np.zeros_like(index)
    bits = math.ceil(math.log2(max_index))
    bits = max(bits + bits % 2, MIN_BLOCK_BITS)
    keys = _seed_seq(seed & _M32, ROUNDS)
    half = bits // 2
    if bits == MIN_BLOCK_BITS:
        # the smallest block holds at most 65536 values while an epoch may
        # hold few: walk the cycles on the whole block's table by pointer
        # doubling.  nxt[v] is the first value <= max_index after v where
        # done[v], else the value 2**r steps after v
        # (an index of 4**8 wraps to 0, as Grain's bitset does)
        start = index & ((1 << bits) - 1)
        nxt = _encrypt(np.arange(1 << bits, dtype=np.uint64), keys,
                       half).astype(np.int64)
        done = nxt <= max_index
        for _ in range(bits + 1):
            if done[start].all():
                break
            nxt, done = (np.where(done, nxt, nxt[nxt]),
                         done | done[nxt])
        return nxt[start]
    out = index.astype(np.uint64)
    todo = np.arange(out.size)
    while todo.size:
        out[todo] = _encrypt(out[todo], keys, half)
        todo = todo[out[todo] > max_index]
    return out.astype(np.int64)


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The record indices of epoch ``epoch`` in the order Grain reads them."""
    return index_shuffle(np.arange(n), n - 1, (seed + epoch) % 2 ** 32)


class _FrameSource:
    """Random access to a FrameDataset's (frame, label) pairs, normalized
    per item: no second full-corpus copy is made, so a memory-mapped
    dataset stays on disk."""

    def __init__(self, ds: FrameDataset, normalizer: Tanhize | None):
        self._x = ds.x
        self._y = ds.y
        self._norm = normalizer

    def __len__(self) -> int:
        return self._x.shape[0]

    def __getitem__(self, i):
        x = self._x[i]
        if self._norm is not None:
            x = self._norm.forward(x).astype(np.float32)
        return x, self._y[i]


class GrainBatches:
    """The batch stream of ``grain_batches``; ``skip(n)`` advances it by n
    batches without reading a record (a trainer resumed from a checkpoint
    calls it)."""

    def __init__(self, ds: FrameDataset, batch_size: int, seed: int,
                 normalizer: Tanhize | None, num_epochs: int | None):
        self._source = _FrameSource(ds, normalizer)
        self._n = len(self._source)
        if self._n <= 0:
            raise ValueError("grain_batches: the dataset has no records")
        if num_epochs is not None and num_epochs <= 0:
            raise ValueError(f"num_epochs must be positive, not {num_epochs}")
        if not isinstance(seed, int) or seed < 0 or seed.bit_length() > 32:
            raise ValueError(f"seed must be an int in [0, 2**32): {seed!r}")
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, not {batch_size}")
        self._bs = batch_size
        self._seed = seed
        self._total = None if num_epochs is None else num_epochs * self._n
        self._k = 0
        self._orders: dict[int, np.ndarray] = {}

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        return self

    def skip(self, n_batches: int) -> None:
        self._k += n_batches

    def _order(self, epoch: int) -> np.ndarray:
        if epoch not in self._orders:
            # the stream only runs forward: keep the epoch before
            self._orders = {e: o for e, o in self._orders.items()
                            if e == epoch - 1}
            self._orders[epoch] = epoch_order(self._n, self._seed, epoch)
        return self._orders[epoch]

    def indices(self, k: int) -> np.ndarray:
        """The record indices of batch ``k``."""
        lo, hi = k * self._bs, (k + 1) * self._bs
        parts = []
        while lo < hi:
            epoch, i = divmod(lo, self._n)
            take = min(hi - lo, self._n - i)
            parts.append(self._order(epoch)[i:i + take])
            lo += take
        return np.concatenate(parts)

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        if (self._total is not None
                and (self._k + 1) * self._bs > self._total):
            raise StopIteration
        idx = self.indices(self._k)
        self._k += 1
        xs, ys = zip(*(self._source[int(i)] for i in idx))
        return np.asarray(np.stack(xs)), np.asarray(np.stack(ys))


def grain_batches(ds: FrameDataset, batch_size: int, seed: int = 0,
                  normalizer: Tanhize | None = None,
                  num_epochs: int | None = None) -> GrainBatches:
    """Deterministic epoch-shuffled batches ``(x float32 [B, D], y int32
    [B])`` in Grain's order; ``num_epochs=None`` is endless, and a last
    partial batch is dropped."""
    return GrainBatches(ds, batch_size, seed, normalizer, num_epochs)
