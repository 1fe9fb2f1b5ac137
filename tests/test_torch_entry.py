"""The port's corpus-analysis and streaming entry points against the JAX
package, on the CPU: the .bin record format and its bytes, ``Tanhize``,
``f0_statistics``, ``analyze_corpus`` on a tiny synthetic corpus (and the
``tpuvc_torch.cli.analyze`` CLI over it), and ``StreamingConverter`` /
``MultiStreamConverter``: their chunking and crossfades against the JAX
classes over one deterministic stand-in converter, and the cases of
tests/test_streaming.py on the port's own ``Converter``."""

import os

import numpy as np
import pytest
import torch

from tests.conftest import make_harmonic
from tpuvc_torch.dsp.constants import DEFAULT_WORLD
from tpuvc_torch.io import records as port_records


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one PyTorch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(rng, n=37, label=3):
    sp = rng.uniform(1e-8, 1.0, (n, 513)).astype(np.float32)
    return sp, port_records.Features(
        sp=np.log10(sp), ap=rng.uniform(0, 1, (n, 513)).astype(np.float32),
        f0=np.where(rng.random(n) < 0.3, 0.0,
                    rng.uniform(80, 300, n)).astype(np.float32),
        en=rng.uniform(0.1, 10.0, n).astype(np.float32), label=label)


def test_records_bytes_match_jax(tmp_path):
    """pack_records/write_bin write the JAX package's bytes exactly, read
    back to the same arrays, and energy_normalize_sp is the same numpy
    arithmetic (bit-equal)."""
    from tpuvc.io import records as jax_records
    sp, f = _features(np.random.default_rng(0))
    jf = jax_records.Features(sp=f.sp, ap=f.ap, f0=f.f0, en=f.en,
                              label=f.label)
    assert np.array_equal(port_records.pack_records(f),
                          jax_records.pack_records(jf))
    port_records.write_bin(str(tmp_path / "p.bin"), f)
    jax_records.write_bin(str(tmp_path / "j.bin"), jf)
    assert ((tmp_path / "p.bin").read_bytes()
            == (tmp_path / "j.bin").read_bytes())
    back = port_records.read_bin(str(tmp_path / "j.bin"))
    for k in ("sp", "ap", "f0", "en"):
        assert np.array_equal(getattr(back, k), getattr(f, k)), k
    assert back.label == f.label
    for a, b in zip(port_records.energy_normalize_sp(sp),
                    jax_records.energy_normalize_sp(sp)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="RECORD_DIM"):
        np.zeros(10, np.float32).tofile(tmp_path / "bad.bin")
        port_records.read_bin(str(tmp_path / "bad.bin"))


def test_tanhize_and_f0_statistics_match_jax():
    """Tanhize forward/backward on numpy equal the JAX package's bit for
    bit (same numpy arithmetic); on a torch tensor the same values to
    float32 rounding (rtol 1e-6 / atol 1e-6).  f0_statistics equal,
    the unvoiced speaker's (nan, 1.0) included."""
    from tpuvc.convert.f0 import f0_statistics as jax_stats
    from tpuvc.data.normalizer import Tanhize as JaxTanhize
    from tpuvc_torch.convert.f0 import f0_statistics
    from tpuvc_torch.data.normalizer import Tanhize
    rng = np.random.default_rng(1)
    x = rng.uniform(-9, 0, (50, 513)).astype(np.float32)
    t, jt = Tanhize.fit(x), JaxTanhize.fit(x)
    assert np.array_equal(t.xmin, jt.xmin) and np.array_equal(t.xmax, jt.xmax)
    q = rng.uniform(-10, 1, (7, 513)).astype(np.float32)
    u = t.forward(q)
    assert np.array_equal(u, jt.forward(q))
    assert np.array_equal(t.backward(u), jt.backward(u))
    ut = t.forward(torch.from_numpy(q))
    np.testing.assert_allclose(ut.numpy(), u, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.backward(ut).numpy(), t.backward(u),
                               rtol=1e-6, atol=1e-6)
    f0s = [np.where(rng.random(60) < 0.4, 0.0, rng.uniform(90, 250, 60))
           for _ in range(3)]
    assert f0_statistics(f0s) == jax_stats(f0s)
    nan = f0_statistics([np.zeros(5)])
    assert np.isnan(nan[0]) and nan[1] == 1.0 and np.isnan(
        jax_stats([np.zeros(5)])[0])


def _write_corpus(root, n_spk=2, n_utt=2):
    """Speakers S0, S1 with n_utt 0.45 s harmonic utterances each in the
    training split and one in the testing split."""
    from tpuvc.io.corpus import TEST_SPLIT, TRAIN_SPLIT
    from tpuvc_torch.io.wav import write_wav
    for s in range(n_spk):
        for split, n in ((TRAIN_SPLIT, n_utt), (TEST_SPLIT, 1)):
            for u in range(n):
                x = make_harmonic(110.0 + 70.0 * s + 9.0 * u, dur_s=0.45,
                                  n_harm=8, noise=0.004, seed=u)
                write_wav(os.path.join(root, "wav", split, f"S{s}",
                                       f"u{u}.wav"), 0.8 * x, 16000)


def test_analyze_corpus_matches_jax(tmp_path):
    """analyze_corpus on the CPU (bucket 0.5 s, DEFAULT_WORLD) against the
    JAX package's on the same tiny corpus: the same files; in every
    record the label and, per tests/test_torch_dsp.py's analysis bounds,
    voicing >= 98% equal and voiced f0 within 1e-3 relative, the
    normalised log10 envelope within 0.05 (0.5 dB), ap within 0.05 dB
    where neither side is fully aperiodic, energy within 2%; the stats
    within the same bounds (xmin/xmax 0.05, f0 mean 1e-3, std 5%).  The
    utterances stop abruptly, so the last frames' StoneMask windows
    (+-512 samples) are half silence, where the refined f0 turns on
    rounding: those frames' f0 within 3% (measured 1.8%) and their ap,
    which D4C computes at that f0, within 0.5 dB."""
    from tpuvc.data.analyze_corpus import analyze_corpus as jax_analyze
    from tpuvc.io import corpus as jax_corpus
    from tpuvc.io.records import read_bin as jax_read
    from tpuvc_torch.data.analyze_corpus import analyze_corpus
    from tpuvc_torch.io import corpus
    for d in ("port", "jax"):
        _write_corpus(str(tmp_path / d))
    analyze_corpus(str(tmp_path / "port"), DEFAULT_WORLD, bucket_s=0.5,
                   device="cpu")
    from tpuvc.dsp.constants import DEFAULT_WORLD as JAX_WORLD
    jax_analyze(str(tmp_path / "jax"), JAX_WORLD, bucket_s=0.5)
    bins = {}
    for d in ("port", "jax"):
        bins[d] = [os.path.relpath(p, tmp_path / d) for split in (
            corpus.TRAIN_SPLIT, corpus.TEST_SPLIT)
            for p in corpus.list_bins(str(tmp_path / d), split)]
    assert bins["port"] == bins["jax"] and len(bins["port"]) == 6
    for rel in bins["port"]:
        g = port_records.read_bin(str(tmp_path / "port" / rel))
        r = jax_read(str(tmp_path / "jax" / rel))
        assert g.label == r.label and g.sp.shape == r.sp.shape
        assert np.all(np.isfinite(g.sp)) and np.all(np.isfinite(g.ap))
        assert np.mean((g.f0 > 0) == (r.f0 > 0)) >= 0.98
        both = (g.f0 > 0) & (r.f0 > 0)
        assert both.mean() > 0.5
        inside = np.arange(len(g.f0)) * 80 + 512 <= 0.45 * 16000
        for part, rtol in ((inside, 1e-3), (~inside, 3e-2)):
            np.testing.assert_allclose(g.f0[both & part], r.f0[both & part],
                                       rtol=rtol)
        assert np.abs(g.sp - r.sp).max() < 0.05
        rest = ~np.all(g.ap >= 1 - 1e-6, -1) & ~np.all(r.ap >= 1 - 1e-6, -1)
        for part, db in ((inside, 0.05), (~inside, 0.5)):
            sel = rest & part
            assert np.abs(20 * np.log10(g.ap[sel] / r.ap[sel])).max() < db
        np.testing.assert_allclose(g.en, r.en, rtol=2e-2)
    etc_p, etc_j = (str(tmp_path / d / "etc") for d in ("port", "jax"))
    assert corpus.read_speakers(etc_p) == jax_corpus.read_speakers(etc_j)
    for a, b in zip(corpus.load_norm_stats(etc_p),
                    jax_corpus.load_norm_stats(etc_j)):
        assert np.abs(a - b).max() < 0.05
    (mu, sd), (jmu, jsd) = (corpus.load_f0_stats(etc_p),
                            jax_corpus.load_f0_stats(etc_j))
    np.testing.assert_allclose(mu, jmu, atol=1e-3)
    np.testing.assert_allclose(sd, jsd, rtol=5e-2)


def test_cli_analyze(tmp_path, capsys):
    """python -m tpuvc_torch.cli.analyze: the card by default (without one
    it raises rather than run on the CPU), --device cpu when asked,
    records and finite stats under etc/; the fs and Harvest grid checks
    of the JAX CLI refuse the same rates."""
    import inspect
    from tpuvc_torch.cli import analyze
    from tpuvc_torch.data import analyze_corpus
    from tpuvc_torch.io import corpus
    assert (inspect.signature(analyze_corpus.analyze_corpus)
            .parameters["device"].default == "cuda")
    root = str(tmp_path)
    _write_corpus(root, n_utt=1)
    args = ["--corpus", root, "--bucket-s", "0.5", "--splits", "train"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            analyze.main(args + ["--quiet"])
    analyze.main(args + ["--device", "cpu"])
    assert "[analyze] done" in capsys.readouterr().out
    assert len(corpus.list_bins(root, corpus.TRAIN_SPLIT)) == 2
    assert corpus.list_bins(root, corpus.TEST_SPLIT) == []
    xmin, xmax = corpus.load_norm_stats(os.path.join(root, "etc"))
    mu, sd = corpus.load_f0_stats(os.path.join(root, "etc"))
    assert xmin.shape == (513,) and np.all(np.isfinite(xmin + xmax))
    assert np.all(np.isfinite(mu)) and np.all(sd > 0)
    for bad in (["--fs", "44100"], ["--fs", "22050", "--f0-method",
                                    "harvest"]):
        with pytest.raises(SystemExit):
            analyze.main(args + ["--device", "cpu"] + bad)


class _StandIn:
    """A deterministic converter for the streaming logic: each window maps
    to tanh(1.3 x) + 1e-3 * seed, per row and seed, as both packages'
    Converter.convert / convert_batch are called."""

    def convert(self, x, src, trg, seed=0, fs=None):
        x = np.asarray(x, np.float32)
        return np.tanh(1.3 * x) + np.float32(1e-3 * seed) * (src != trg)

    def convert_batch(self, xs, srcs, trgs, seed=0, fs=None, mesh=None):
        seeds = np.asarray(seed) if np.ndim(seed) else seed + np.arange(
            len(xs))
        return [self.convert(x, s, t, int(k))
                for x, s, t, k in zip(xs, srcs, trgs, seeds)]


def test_streaming_logic_matches_jax():
    """Over the same stand-in converter, the port's StreamingConverter and
    MultiStreamConverter return exactly the JAX classes' samples (the
    same chunking, halos, seeds and equal-power crossfades), fed in
    ragged blocks."""
    from tpuvc.convert import streaming as jax_streaming
    from tpuvc_torch.convert import streaming
    conv = _StandIn()
    rng = np.random.default_rng(2)
    xa = rng.uniform(-1, 1, 51000).astype(np.float32)
    xb = rng.uniform(-1, 1, 43000).astype(np.float32)
    outs = []
    for mod in (streaming, jax_streaming):
        s = mod.StreamingConverter(conv, "A", "B", chunk_s=1.0, seed=4)
        y = [s.push(xa[i:i + 7001]) for i in range(0, len(xa), 7001)]
        m = mod.MultiStreamConverter(conv, [("A", "B"), ("B", "B")],
                                     chunk_s=0.5, seed=2)
        ys = [[], []]
        for i in range(0, len(xa), 9000):
            ys[0].append(m.push(0, xa[i:i + 9000]))
            ys[1].append(m.push(1, xb[i:i + 4000]))
        m.tick()
        for i, tail in enumerate(m.flush_all()):
            ys[i].append(tail)
        outs.append([np.concatenate(y + [s.flush()])]
                    + [np.concatenate(v) for v in ys])
    for got, ref in zip(*outs):
        assert got.shape == ref.shape and np.array_equal(got, ref)


@pytest.fixture(scope="module")
def converter():
    """The port's Converter on the CPU over tests/test_streaming.py's
    small architecture, seeded random weights."""
    from tpuvc_torch.convert.pipeline import Converter, ConverterAssets
    from tpuvc_torch.models import params
    from tpuvc_torch.utils.config import Architecture, NetSpec
    arch = Architecture(
        model="VAE", z_dim=16, y_dim=2, y_emb_dim=8,
        encoder=NetSpec((7, 7), (3, 3), (8, 16)),
        generator=NetSpec((7, 7, 7), (3, 3, 3), (16, 8, 1)),
        discriminator=NetSpec((7,), (3,), (8,)))
    model = params.load_model(arch, params.init_params(
        arch, torch.Generator().manual_seed(0), device="cpu"), device="cpu")
    assets = ConverterAssets(
        xmin=np.full(513, -10.0, np.float32),
        xmax=np.full(513, 1.0, np.float32),
        f0_mu=np.array([5.0, 5.3], np.float32),
        f0_sigma=np.array([1.0, 1.0], np.float32), speakers=["A", "B"])
    return Converter(model, assets, DEFAULT_WORLD, bucket_s=1.0,
                     device="cpu")


def test_streaming_length_and_continuity(converter):
    """tests/test_streaming.py's first case on the port: the streamed
    output has the input's length (to a halo and a hop), is finite and
    voiced, and steps at the chunk joins stay within 6x the signal's
    99.9th-percentile step."""
    from tpuvc_torch.convert.streaming import StreamingConverter
    cfg = DEFAULT_WORLD
    x = make_harmonic(150.0, fs=cfg.fs, dur_s=3.2, n_harm=8, noise=0.003)
    s = StreamingConverter(converter, "A", "B", chunk_s=1.0)
    y = np.concatenate([s.push(x[i:i + 3001]) for i in range(0, len(x), 3001)]
                       + [s.flush()])
    assert abs(len(y) - len(x)) <= s.halo + cfg.hop, (len(y), len(x))
    assert np.all(np.isfinite(y)) and np.std(y) > 1e-4
    step = np.abs(np.diff(y))
    p999 = np.quantile(step, 0.999)
    for join in (s.chunk, 2 * s.chunk):
        assert step[join - 100:join + 100].max() < 6 * p999 + 1e-3, join


def test_streaming_resembles_batch_and_multistream_equals_solo(converter):
    """tests/test_streaming.py's other cases on the port: the streamed
    output's level within 15% and its mid-utterance mean envelope within
    1 dB of the one-shot conversion's, a second pass bit-identical; and
    two streams batched per tick equal two solo streams to batching
    rounding.  PyTorch's CPU kernels take other paths at batch 2 than at
    batch 1 (one utterance converted in a batch of 2 vs alone: 80.7 dB),
    and this random model's output is loud (RMS ~2.4), so the bound is a
    waveform SNR >= 60 dB rather than JAX's atol 5e-4."""
    from tpuvc_torch.convert.streaming import (MultiStreamConverter,
                                               StreamingConverter)
    from tpuvc_torch.dsp.world import analyze
    cfg = DEFAULT_WORLD
    x = make_harmonic(140.0, fs=cfg.fs, dur_s=2.4, n_harm=8, noise=0.003)
    y_full = converter.convert(x, "A", "B")
    runs = []
    for _ in range(2):
        s = StreamingConverter(converter, "A", "B", chunk_s=1.0)
        runs.append(np.concatenate([s.push(x), s.flush()]))
    np.testing.assert_array_equal(runs[0], runs[1])
    n = min(len(y_full), len(runs[0]))
    assert np.std(runs[0][:n]) == pytest.approx(np.std(y_full[:n]), rel=0.15)
    sp_f, sp_s = (10 * np.log10(analyze(y[:n], cfg, device="cpu").sp.numpy()
                                + 1e-20) for y in (y_full, runs[0]))
    mid = slice(len(sp_f) // 4, 3 * len(sp_f) // 4)
    assert np.abs(sp_f[mid].mean(0) - sp_s[mid].mean(0)).mean() < 1.0

    xa = make_harmonic(150.0, fs=cfg.fs, dur_s=2.3, n_harm=8, noise=0.003)
    xb = make_harmonic(210.0, fs=cfg.fs, dur_s=2.3, n_harm=6, noise=0.004)
    m = MultiStreamConverter(converter, [("A", "B"), ("B", "A")],
                             chunk_s=1.0, seed=5)
    outs = [[m.push(0, xa)], [m.push(1, xb)]]
    for i, tail in enumerate(m.flush_all()):
        outs[i].append(tail)
    for sid, (x1, (src, trg)) in enumerate(((xa, ("A", "B")),
                                            (xb, ("B", "A")))):
        solo = StreamingConverter(converter, src, trg, chunk_s=1.0,
                                  seed=5 + 7919 * sid)
        y_solo = np.concatenate([solo.push(x1), solo.flush()])
        y_multi = np.concatenate(outs[sid])
        assert y_multi.shape == y_solo.shape
        err = np.sum((y_multi - y_solo).astype(np.float64) ** 2)
        assert 10 * np.log10(np.sum(y_solo.astype(np.float64) ** 2)
                             / max(err, 1e-30)) >= 60.0
