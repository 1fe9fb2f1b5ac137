"""The port's Grain-order input pipeline (tpuvc_torch/data/grain_pipeline.py)
against the JAX package's Grain DataLoader, and chip_smoke.py's phase 11
rehearsed on the CPU.

The port imports no Grain: it reproduces Grain's compiled
``index_shuffle`` in numpy, so its batches must equal the JAX function's
bit for bit, across epoch boundaries too.  Grain is needed only on the
JAX side (``pytest.importorskip``).
"""

import os
import sys

import numpy as np
import pytest
import torch

from tpuvc_torch.data import grain_pipeline as gp
from tpuvc_torch.data.dataset import FrameDataset
from tpuvc_torch.data.normalizer import Tanhize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one PyTorch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(n: int = 100, d: int = 8, seed: int = 0) -> FrameDataset:
    rng = np.random.default_rng(seed)
    return FrameDataset(x=rng.standard_normal((n, d)).astype(np.float32),
                        y=np.arange(n, dtype=np.int32))


def _small_arch(batch_size: int, **fields):
    """tests/test_torch_train.py's narrow architecture."""
    from tpuvc_torch.utils import config
    return config.Architecture(
        z_dim=16, y_dim=4, y_emb_dim=8,
        encoder=config.NetSpec((7, 7), (3, 3), (8, 16)),
        generator=config.NetSpec((7, 7, 7), (3, 3, 3), (16, 8, 1)),
        discriminator=config.NetSpec((7, 7), (3, 3), (8, 16)),
        training=config.TrainConfig(batch_size=batch_size, lr=1e-3,
                                    n_unroll=2),
        **fields)


def _jax(ds, **kw):
    pytest.importorskip("grain")
    from tpuvc.data.dataset import FrameDataset as JaxFrameDataset
    from tpuvc.data.grain_pipeline import grain_batches
    return list(grain_batches(JaxFrameDataset(x=ds.x, y=ds.y), **kw))


def _assert_same(got, want):
    assert len(got) == len(want)
    for (xa, ya), (xb, yb) in zip(got, want):
        assert xa.dtype == xb.dtype == np.float32
        assert ya.dtype == yb.dtype
        assert xa.shape == xb.shape and ya.shape == yb.shape
        assert xa.tobytes() == xb.tobytes() and ya.tobytes() == yb.tobytes()


@pytest.mark.parametrize("n", [1, 2, 3, 17, 100, 1000, 4097, 65537, 70001])
@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5, 2 ** 32 - 1])
def test_index_shuffle_matches_grains_compiled_module(n, seed):
    """The numpy index_shuffle against Grain's compiled one, element by
    element (every index of small epochs, 2000 of large ones; the 16-bit
    block's table walk and the wider blocks' cycle walk)."""
    pytest.importorskip("grain")
    from grain._src.python.experimental.index_shuffle.python import (
        index_shuffle_module as ism)
    rng = np.random.default_rng(n)
    idx = np.arange(n) if n <= 4097 else rng.integers(0, n, 2000)
    want = [ism.index_shuffle(int(i), max_index=n - 1, seed=seed, rounds=4)
            for i in idx]
    np.testing.assert_array_equal(gp.index_shuffle(idx, n - 1, seed), want)


@pytest.mark.parametrize("epochs", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5])
@pytest.mark.parametrize("batch", [16, 40])
def test_grain_batches_match_jax(batch, seed, epochs):
    """100 records, batches of 16 and 40 (which straddle epoch
    boundaries), three seeds, 2 and 3 epochs: batch for batch equal to
    the JAX package's grain_batches."""
    ds = _dataset()
    kw = dict(batch_size=batch, seed=seed, num_epochs=epochs)
    got = list(gp.grain_batches(ds, **kw))
    _assert_same(got, _jax(ds, **kw))
    assert len(got) == epochs * 100 // batch


def test_grain_batches_first_labels():
    """The first batch of seed 1 is Grain's index_shuffle(0..., 99, 1)."""
    (x, y), = list(gp.grain_batches(_dataset(), 100, seed=1, num_epochs=1))
    assert y[:6].tolist() == [35, 7, 50, 32, 73, 40]


def test_grain_batches_normalised_memmap_match_jax(tmp_path):
    """A memory-mapped FrameDataset of 513-wide frames with a normalizer:
    the rows equal the JAX stream's and each equals Tanhize.forward of its
    own frame (normalised per item, the memory map never copied)."""
    from tpuvc.data.normalizer import Tanhize as JaxTanhize
    rng = np.random.default_rng(5)
    x = (3 * rng.standard_normal((203, 513))).astype(np.float32)
    path = str(tmp_path / "x.f32")
    x.tofile(path)
    mapped = np.memmap(path, dtype=np.float32, mode="r", shape=x.shape)
    ds = FrameDataset(x=mapped, y=rng.integers(0, 10, 203).astype(np.int32))
    norm = Tanhize.fit(x[:50])
    got = list(gp.grain_batches(ds, 32, seed=9, normalizer=norm,
                                num_epochs=2))
    want = _jax(ds, batch_size=32, seed=9,
                normalizer=JaxTanhize(xmin=norm.xmin, xmax=norm.xmax),
                num_epochs=2)
    _assert_same(got, want)
    stream = gp.grain_batches(ds, 32, seed=9, num_epochs=2)
    for k, (xb, _) in enumerate(got):
        idx = stream.indices(k)
        np.testing.assert_array_equal(
            xb, np.stack([norm.forward(x[i]).astype(np.float32)
                          for i in idx]))
    assert type(ds.x) is np.memmap


@pytest.mark.parametrize("n,batch,epochs", [(100, 16, 2), (100, 40, 3),
                                            (37, 50, 3), (64, 8, 1)])
def test_grain_batches_contract(n, batch, epochs):
    """Each epoch a permutation; floor(epochs * n / batch) batches across
    epoch boundaries; the labels in the epochs' order; the same seed the
    same stream, another seed another."""
    ds = _dataset(n)
    got = list(gp.grain_batches(ds, batch, seed=4, num_epochs=epochs))
    assert len(got) == epochs * n // batch
    orders = [gp.epoch_order(n, 4, e) for e in range(epochs)]
    for o in orders:
        np.testing.assert_array_equal(np.sort(o), np.arange(n))
    labels = np.concatenate([y for _, y in got]) if got else []
    np.testing.assert_array_equal(
        labels, np.concatenate(orders)[:len(got) * batch])
    _assert_same(got, list(gp.grain_batches(ds, batch, seed=4,
                                            num_epochs=epochs)))
    other = list(gp.grain_batches(ds, batch, seed=5, num_epochs=epochs))
    assert any(a[1].tobytes() != b[1].tobytes()
               for a, b in zip(got, other))


def test_grain_batches_endless_and_skip():
    """num_epochs=None runs on past any epoch; skip(k) lands on the k-th
    batch of a fresh stream without reading a record (a resumed trainer
    calls it)."""
    ds = _dataset(30)
    endless = gp.grain_batches(ds, 7)
    first = [next(endless) for _ in range(20)]      # 140 frames: 4+ epochs
    _assert_same(first[:8], list(gp.grain_batches(ds, 7, num_epochs=2)))
    resumed = gp.grain_batches(ds, 7)
    resumed.skip(13)
    _assert_same([next(resumed) for _ in range(7)], first[13:])


@pytest.mark.parametrize("kw", [dict(seed=-1), dict(seed=2 ** 32),
                                dict(num_epochs=0), dict(batch_size=0)])
def test_grain_batches_rejects_what_grain_rejects(kw):
    args = dict(batch_size=4, seed=0, num_epochs=None) | kw
    with pytest.raises(ValueError):
        gp.grain_batches(_dataset(10), **args)


def test_grain_batches_feed_a_trainer_on_resume(tmp_path):
    """A VAE trainer resumed from its checkpoint skips the stream to where
    it left off: the steps after the resume see the batches a run without
    the break saw."""
    from tpuvc_torch.train.trainer import make_trainer
    arch = _small_arch(model="VAE", trainer="VAETrainer", batch_size=8)
    rng = np.random.default_rng(0)
    ds = FrameDataset(x=rng.uniform(-1, 1, (40, 513)).astype(np.float32),
                      y=rng.integers(0, 4, 40).astype(np.int32))
    seen = []

    class Recorded(gp.GrainBatches):
        def __next__(self):
            b = super().__next__()
            seen.append(b[1].tobytes())
            return b

    def run(run_dir, steps):
        t = make_trainer(arch, str(run_dir), use_tensorboard=False,
                         device="cpu")
        t.train(Recorded(ds, 8, 0, None, None), steps, save_every=2)
        t.close()

    run(tmp_path / "a", 4)
    straight, seen[:] = list(seen), []
    run(tmp_path / "b", 2)
    run(tmp_path / "b", 4)
    assert seen == straight


# --- chip_smoke.py's phase 11, rehearsed on the CPU ----------------------

def test_phase11_rehearses_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.phase_host on the CPU at a small size: a 2-speaker
    corpus analysed by the port, the library hit, the WAV, record and
    gather equalities, grain_batches over the memory map for two epochs
    and 3 steps of a small VAW-GAN fed by it (no kernel launch on the
    CPU)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from tpuvc_torch.data import synthetic
    from tpuvc_torch.data.analyze_corpus import analyze_corpus
    from tpuvc_torch.io import corpus as corpus_io
    corpus = str(tmp_path / "corpus")
    defs = dict(list(synthetic.SPEAKER_DEFS.items())[:2])
    synthetic.make_corpus(corpus, n_train=2, n_test=1, dur_s=0.5, seed=0,
                          speaker_defs=defs)
    analyze_corpus(corpus, splits=(corpus_io.TRAIN_SPLIT,), bucket_s=0.5,
                   device="cpu")
    arch = _small_arch(batch_size=16)
    arch.save(str(tmp_path / "small.json"))
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    rec = chip_smoke.phase_host(torch.device("cpu"), corpus, str(tmp_path),
                                arch_path="small.json", steps=3,
                                gather=64, reps=2)
    assert rec["grain"]["batch"] == 16
    assert rec["grain"]["batches"] == 2 * rec["grain"]["frames"] // 16
    assert rec["train"]["steps"] == 3 and rec["train"]["last"]["step"] == 3
    assert all(v > 0 for v in rec["wav_ms_per_file"].values())
    assert all(v > 0 for v in rec["gather_ms"].values())
