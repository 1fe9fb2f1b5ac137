"""The port's conversion CLI (tpuvc_torch.cli.convert) and
``make_convert_fn(sample_z=True)`` against the JAX package's, on the CPU.

One tiny parallel synthetic corpus (4 speakers, 2 training and 1 test
utterance of 0.6 s each) analysed once by the port; one Flax
``init_params`` per model kind gives both sides' checkpoints: the JAX
package's Orbax state and the port's ``ckpt/<step>.pt`` (``from_flax``,
``critic_from_flax``), so both convert with the same parameters and no
training is needed.  The port's synthesis noise is replaced by JAX's
draws for the same seeds, so waveforms compare sample by sample."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuvc.utils.config import Architecture, NetSpec, TrainConfig
from tpuvc_torch.io import corpus as corpus_io
from tpuvc_torch.utils import config as port_config

STEP = 3
# tests/test_training.py's small architecture, 4 speakers
SMALL = dict(
    z_dim=16, y_dim=4, y_emb_dim=8,
    encoder=NetSpec((7, 7), (3, 3), (8, 16)),
    generator=NetSpec((7, 7, 7), (3, 3, 3), (16, 8, 1)),
    discriminator=NetSpec((7, 7), (3, 3), (8, 16)),
    training=TrainConfig(batch_size=32, lr=1e-3, n_unroll=2))
MODELS = {"VAWGAN": "VAWGANTrainer", "VAE": "VAETrainer"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the machine: one PyTorch thread
    each (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_noise(seeds, n_samples, device):
    """JAX's synthesis noise for ``seeds`` (jax.random.normal under
    PRNGKey(seed)), in the port's ``synthesis_noise`` signature."""
    return torch.stack([torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.PRNGKey(int(s)), (n_samples,), jnp.float32)))
        for s in np.asarray(seeds).reshape(-1)]).to(device)


def snr_db(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(10 * np.log10(np.sum(ref ** 2)
                               / max(np.sum((got - ref) ** 2), 1e-30)))


def make_corpus(root: str) -> str:
    """The parallel 4-speaker corpus under ``root``, its training split
    analysed by the port (etc/ stats both CLIs read)."""
    from tpuvc_torch.data.analyze_corpus import analyze_corpus
    from tpuvc_torch.data.synthetic import make_corpus as make
    from tpuvc_torch.dsp.constants import DEFAULT_WORLD
    make(root, n_train=2, n_test=1, dur_s=0.6, seed=0, parallel=True)
    analyze_corpus(root, DEFAULT_WORLD, splits=(corpus_io.TRAIN_SPLIT,),
                   device="cpu")
    return root


def make_runs(root: str, model: str) -> tuple[str, str]:
    """(JAX run dir, port run dir) of a ``model`` run at step STEP, both
    holding the parameters of one Flax init_params."""
    from tpuvc.models.vae import make_model
    from tpuvc.train import steps as jax_steps
    from tpuvc.train.checkpoint import Checkpointer as JaxCheckpointer
    from tpuvc_torch.models import params as port_params
    from tpuvc_torch.train import steps as port_steps
    from tpuvc_torch.train.checkpoint import Checkpointer
    arch = Architecture(model=model, trainer=MODELS[model], **SMALL)
    parch = port_config.Architecture.from_json(arch.to_json())
    jmodel = make_model(arch)
    key = jax.random.PRNGKey(0)
    if model == "VAWGAN":
        state = jax_steps.init_vawgan_state(jmodel, arch, key)
    else:
        state = jax_steps.init_vae_state(jmodel, arch, key)
    jax_run, port_run = (os.path.join(root, f"{model}-{side}")
                         for side in ("jax", "port"))
    for run in (jax_run, port_run):
        os.makedirs(run)
        arch.save(os.path.join(run, "architecture.json"))
    ck = JaxCheckpointer(os.path.join(jax_run, "ckpt"))
    ck.save(STEP, jax.device_get(state))
    ck.wait()
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    gen = port_params.from_flax(tree, parch)
    pstate = (port_steps.vawgan_state(
        parch, gen, port_params.critic_from_flax(tree, parch), "cpu")
        if model == "VAWGAN" else port_steps.vae_state(parch, gen, "cpu"))
    Checkpointer(os.path.join(port_run, "ckpt")).save(STEP, pstate)
    return jax_run, port_run


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    corpus = make_corpus(os.path.join(root, "corpus"))
    return corpus, {m: make_runs(root, m) for m in MODELS}


@pytest.fixture
def jax_drawn(monkeypatch):
    """The port's converter draws JAX's synthesis noise."""
    from tpuvc_torch.convert import pipeline
    monkeypatch.setattr(pipeline, "synthesis_noise", jax_noise)


def _utterance(corpus, spk="SA"):
    from tpuvc_torch.io.wav import read_wav
    return read_wav(corpus_io.list_wavs(corpus, corpus_io.TEST_SPLIT,
                                        spk)[0])[0].astype(np.float32)


@pytest.mark.parametrize("model", list(MODELS))
def test_load_converter_matches_jax(setup, jax_drawn, model):
    """load_converter restores the newest checkpoint's generator (the
    "gen" entry of a VAW-GAN run, "model" of a VAE run, loaded with
    strict=True) and the corpus stats: one utterance through both
    converters, waveform SNR >= 40 dB."""
    from tpuvc.cli.convert import load_converter as jax_load
    from tpuvc_torch.cli.convert import load_converter
    corpus, runs = setup
    jconv, jstep = jax_load(runs[model][0], corpus)
    conv, step = load_converter(runs[model][1], corpus, device="cpu")
    assert step == jstep == STEP
    assert conv.assets.speakers == jconv.assets.speakers == list(
        "SA SB SC SD".split())
    for k in ("xmin", "xmax", "f0_mu", "f0_sigma"):
        np.testing.assert_array_equal(getattr(conv.assets, k),
                                      getattr(jconv.assets, k))
    x = _utterance(corpus)
    ref = jconv.convert(x, "SA", "SB", seed=3)
    got = conv.convert(x, "SA", "SB", seed=3)
    assert got.shape == ref.shape == x.shape
    assert snr_db(ref, got) >= 40.0


def test_load_converter_without_checkpoint_raises(setup, tmp_path):
    from tpuvc_torch.cli.convert import load_converter
    corpus, runs = setup
    run = tmp_path / "run"
    run.mkdir()
    (run / "architecture.json").write_text(
        open(os.path.join(runs["VAE"][1], "architecture.json")).read())
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_converter(str(run), corpus, device="cpu")
    assert not (run / "ckpt").exists()


MODES = {
    "single": ["--src", "SA", "--trg", "SB"],
    "all_pairs": ["--all_pairs", "--transfer-encoding", "ulaw8"],
    "harvest_decim2": ["--src", "SC", "--trg", "SA", "--f0-method",
                       "harvest", "--harvest-decim", "2"],
}
EDGE = 2 * 80      # the last two frames, where the input decays to zero


def assert_waveforms_agree(ref, got):
    """Waveform SNR >= 40 dB over all but the last two frames, and >= 30
    dB (chip_smoke.py's card-vs-CPU bound) over the whole file.  Where the
    input decays into its padding, DIO's derivative events fire on
    rounding-level values of the filtered bank (the two FFTs differ by
    ~1e-7), so the coarse f0 of the last voiced frame may differ by a few
    percent and a pitch pulse land on one side only.  Measured (all-pairs,
    12 files): 48.5-70.0 dB without the last two frames; over whole files
    32.2 dB for SA->SD (all its error in frame 119), >= 44.6 dB for the
    others."""
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    assert snr_db(ref[:-EDGE], got[:-EDGE]) >= 40.0
    assert snr_db(ref, got) >= 30.0


@pytest.mark.parametrize("mode", list(MODES))
def test_convert_cli_matches_jax(setup, jax_drawn, tmp_path, mode):
    """python -m tpuvc_torch.cli.convert against tpuvc.cli.convert on the
    same checkpoint parameters, corpus and noise: the same file names, and
    each file's waveform as ``assert_waveforms_agree`` bounds it; under
    ulaw8 the
    mu-law codes of the two files agree within one step on >= 98% of
    samples."""
    from tpuvc.cli import convert as jax_cli
    from tpuvc_torch.cli import convert as cli
    from tpuvc_torch.io.wav import read_wav
    from tpuvc_torch.ops.ulaw import ulaw_encode
    corpus, runs = setup
    flags = MODES[mode]
    outs = {}
    for side, (run, fn, extra) in {
            "jax": (runs["VAWGAN"][0], jax_cli.main, []),
            "port": (runs["VAWGAN"][1], cli.main, ["--device", "cpu"])}.items():
        out = str(tmp_path / side)
        outs[side] = fn(["--checkpoint", run, "--corpus", corpus,
                         "--output", out, *flags, *extra])
    names = [os.path.basename(o) for o in outs["port"]]
    assert names == [os.path.basename(o) for o in outs["jax"]]
    if mode == "all_pairs":
        assert len(names) == 4 * 1 * 3 and "SA-to-SB-100001.wav" in names
    else:
        assert names == [f"{flags[3]}-100001.wav"]
    for a, b in zip(outs["jax"], outs["port"]):
        ref, got = read_wav(a)[0], read_wav(b)[0]
        assert_waveforms_agree(ref, got)
        if "ulaw8" in flags:
            codes = [ulaw_encode(torch.from_numpy(v)).numpy().astype(int)
                     for v in (ref, got)]
            assert np.mean(np.abs(codes[0] - codes[1]) <= 1) >= 0.98


def test_convert_cli_streaming_resembles_batch(setup, tmp_path):
    """--streaming (0.25 s chunks, several per utterance) against the
    port's own whole-utterance conversion, under
    tests/test_torch_entry.py::test_streaming_resembles_batch_and_multistream_equals_solo's
    bounds: level within 15%, mid-utterance mean envelope within 1 dB."""
    from tpuvc_torch.cli import convert as cli
    from tpuvc_torch.dsp.world import analyze
    from tpuvc_torch.io.wav import read_wav
    corpus, runs = setup
    common = ["--checkpoint", runs["VAWGAN"][1], "--corpus", corpus,
              "--src", "SB", "--trg", "SD", "--device", "cpu"]
    batch = cli.main(common + ["--output", str(tmp_path / "b")])
    stream = cli.main(common + ["--output", str(tmp_path / "s"),
                                "--streaming", "--chunk_s", "0.25"])
    assert [os.path.basename(o) for o in stream] == ["SD-100001.wav"]
    y_full, y_s = (read_wav(o[0])[0] for o in (batch, stream))
    n = min(len(y_full), len(y_s))
    assert np.all(np.isfinite(y_s)) and abs(len(y_s) - len(y_full)) <= 2048
    assert np.std(y_s[:n]) == pytest.approx(np.std(y_full[:n]), rel=0.15)
    sp_f, sp_s = (10 * np.log10(analyze(y[:n], device="cpu").sp.numpy()
                                + 1e-20) for y in (y_full, y_s))
    mid = slice(len(sp_f) // 4, 3 * len(sp_f) // 4)
    assert np.abs(sp_f[mid].mean(0) - sp_s[mid].mean(0)).mean() < 1.0


def test_convert_cli_refusals(setup):
    """tests/test_end2end.py's checks on the port's CLI: an unknown source
    speaker (no wavs) or target raises; without --device cpu and without
    a card the CLI raises instead of falling back, --data_parallel too
    (its default mesh is every card)."""
    from tpuvc_torch.cli import convert as cli
    corpus, runs = setup
    common = ["--checkpoint", runs["VAE"][1], "--corpus", corpus]
    with pytest.raises(FileNotFoundError):
        cli.main(common + ["--src", "NOPE", "--trg", "SB", "--device",
                           "cpu"])
    with pytest.raises((KeyError, ValueError)):
        cli.main(common + ["--src", "SA", "--trg", "NOPE", "--device",
                           "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(common + ["--src", "SA", "--trg", "SB"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(common + ["--all_pairs", "--data_parallel"])


@pytest.mark.parametrize("devices", [1, 4])
def test_convert_cli_data_parallel(setup, tmp_path, monkeypatch, devices):
    """--all_pairs --data_parallel --device cpu writes the files the CLI
    writes without the flag, each within assert_waveforms_agree's bound
    (PR 9's): on the CPU's one device (bit-equal), and on a virtual mesh
    of 4 x cpu (12 conversions: one chunk of 12 rows, 3 per device)."""
    from tpuvc_torch.cli import convert as cli
    from tpuvc_torch.io.wav import read_wav
    from tpuvc_torch.parallel import mesh as mesh_lib
    corpus, runs = setup
    if devices > 1:
        real = mesh_lib.make_mesh
        monkeypatch.setattr(mesh_lib, "make_mesh", lambda devices=None: real(
            devices=devices * 4))
    common = ["--checkpoint", runs["VAWGAN"][1], "--corpus", corpus,
              "--all_pairs", "--device", "cpu"]
    plain = cli.main(common + ["--output", str(tmp_path / "plain")])
    dp = cli.main(common + ["--output", str(tmp_path / "dp"),
                            "--data_parallel"])
    assert [os.path.basename(o) for o in dp] == [
        os.path.basename(o) for o in plain]
    assert len(dp) == 4 * 1 * 3
    for a, b in zip(plain, dp):
        ref, got = read_wav(a)[0], read_wav(b)[0]
        assert_waveforms_agree(ref, got)
        if devices == 1:
            assert np.array_equal(ref, got)


def test_converter_441khz_input_and_chunking(setup):
    """A 44.1 kHz input converts (resampled to the pipeline rate: level
    within a factor 2 of the 16 kHz input's conversion), and a request
    split into chunks by the per-call budget equals one call (atol
    1e-5)."""
    from scipy.signal import resample_poly

    from tpuvc_torch.cli.convert import load_converter
    corpus, runs = setup
    conv, _ = load_converter(runs["VAE"][1], corpus, device="cpu")
    x16 = _utterance(corpus)
    x44 = resample_poly(x16, 441, 160)
    y44 = conv.convert(x44, "SA", "SB", fs=44100)
    y16 = conv.convert(x16, "SA", "SB")
    assert np.all(np.isfinite(y44)) and abs(len(y44) - len(y16)) <= 16000
    n = min(len(y44), len(y16))
    assert 0.5 < np.std(y44[:n]) / max(np.std(y16[:n]), 1e-9) < 2.0
    yb = conv.convert_batch([x44], ["SA"], ["SB"], fs=44100)[0]
    assert np.all(np.isfinite(yb)) and np.std(yb) > 1e-4

    xs = [_utterance(corpus, s) for s in ("SA", "SB")] * 2
    n = len(xs)
    ref = conv.convert_batch(xs, ["SA"] * n, ["SB"] * n, seed=0)
    conv2, _ = load_converter(runs["VAE"][1], corpus, device="cpu")
    conv2.MAX_AUDIO_S_PER_CALL = 1.0       # one utterance per call
    chunked = conv2.convert_batch(xs, ["SA"] * n, ["SB"] * n, seed=0)
    assert len(chunked) == n
    for a, b in zip(ref, chunked):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_make_convert_fn_sample_z_matches_jax(setup):
    """make_convert_fn(sample_z=True) against the JAX function with its
    draws injected (eps = jax.random.normal(PRNGKey(seed), z_mu.shape),
    the synthesis noise under the same key): the utterance's waveform as
    ``assert_waveforms_agree`` bounds it.
    Without eps it draws from a torch.Generator seeded with ``seed``
    (the same output twice), and the sample differs from z_mu's
    decoding."""
    from tpuvc.cli.convert import load_converter as jax_load
    from tpuvc.convert.pipeline import make_convert_fn as jax_make
    from tpuvc_torch.cli.convert import load_converter
    from tpuvc_torch.convert.pipeline import make_convert_fn
    corpus, runs = setup
    jconv, _ = jax_load(runs["VAWGAN"][0], corpus)
    conv, _ = load_converter(runs["VAWGAN"][1], corpus, device="cpu")
    a = conv.assets
    x0 = _utterance(corpus)
    x = np.pad(x0, (0, 16000 - len(x0)))
    stats = (a.xmin, a.xmax, a.f0_mu[0], a.f0_sigma[0], a.f0_mu[2],
             a.f0_sigma[2])
    seed = 7
    ref = np.asarray(jax_make(jconv.model, sample_z=True)(
        jconv.params, jnp.asarray(x), jnp.int32(2),
        *(jnp.asarray(v, jnp.float32) for v in stats), jnp.int32(seed)))
    n = len(x) // 80 + 1
    key = jax.random.PRNGKey(seed)
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, (n, 16))))
    noise = jax_noise([seed], n * 80, "cpu")[0]
    t = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731
    fn = make_convert_fn(conv.model, sample_z=True)
    got = fn(t(x), 2, *(t(v) for v in stats), seed=seed, eps=eps,
             noise=noise).numpy()
    assert got.shape == ref.shape
    assert_waveforms_agree(ref[:len(x0)], got[:len(x0)])
    drawn = [fn(t(x), 2, *(t(v) for v in stats), seed=seed, noise=noise)
             for _ in range(2)]
    torch.testing.assert_close(drawn[0], drawn[1], rtol=0, atol=0)
    mean = make_convert_fn(conv.model)(t(x), 2, *(t(v) for v in stats),
                                       seed=seed, noise=noise).numpy()
    assert snr_db(mean, got) < 40.0
