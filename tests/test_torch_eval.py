"""The port's quality metrics (tpuvc_torch.utils.metrics) and evaluation
CLI (tpuvc_torch.cli.evaluate) against the JAX package's, on the CPU.

The CLIs read tests/test_torch_cli.py's corpus and VAW-GAN checkpoints
(one Flax init_params on both sides); the port's synthesis noise is
replaced by JAX's draws for the same seeds."""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_cli import jax_noise, make_corpus, make_runs
from tpuvc.utils import metrics as jax_metrics
from tpuvc_torch.utils import metrics


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the machine: one PyTorch thread
    each (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _envelopes(seed, t):
    """A smooth positive power envelope sequence [t, 513] with frame-to-
    frame movement, from a numpy seed."""
    rng = np.random.default_rng(seed)
    f = np.linspace(0.0, 1.0, 513)
    tilt = rng.uniform(-8.0, -2.0)
    wob = rng.standard_normal((t, 6)).cumsum(0) * 0.2
    log = tilt * f[None] + sum(wob[:, k:k + 1] * np.cos((k + 1) * np.pi * f)
                               for k in range(6))
    return 10.0 ** (log + 0.05 * rng.standard_normal((t, 513)))


PAIRS = {  # function -> arguments after (sp_a, sp_b), or None for one
    "mel_cepstrum": None, "mel_cepstral_gv": None, "mcd": (),
    "mcd_dtw": (), "gv_ratio_db": (), "ms_highband_ratio_db": (),
    "modulation_spectrum": None,
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_metrics_match_jax_package(name):
    """Each metric of the port's copy equals tpuvc.utils.metrics' on
    seeded random envelopes (unequal lengths for the pairwise ones):
    rtol 1e-12."""
    a, b = _envelopes(1, 70), _envelopes(2, 83)
    if PAIRS[name] is None:
        got, ref = (getattr(m, name)(a, 16000)
                    for m in (metrics, jax_metrics))
    else:
        got, ref = (getattr(m, name)(a, b, 16000)
                    for m in (metrics, jax_metrics))
    for g, r in zip(*((v if isinstance(v, tuple) else (v,))
                      for v in (got, ref))):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    corpus = make_corpus(os.path.join(root, "corpus"))
    return corpus, make_runs(root, "VAWGAN")


def _evaluate(setup, mode):
    """(JAX CLI's JSON, the port CLI's JSON) in ``mode``."""
    from tpuvc.cli import evaluate as jax_cli
    from tpuvc_torch.cli import evaluate as cli
    corpus, (jax_run, port_run) = setup
    flags = ["--corpus", corpus]
    if mode == "conversion":
        flags += ["--src", "SA", "--trg", "SB"]
    ckpt = lambda run: (["--checkpoint", run]  # noqa: E731
                        if mode == "conversion" else [])
    return (jax_cli.main(flags + ckpt(jax_run)),
            cli.main(flags + ckpt(port_run) + ["--device", "cpu"]))


def _agree(ref, got, tol):
    assert list(got) == list(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            assert np.isfinite(got[k]) and abs(got[k] - v) <= tol, (k, got,
                                                                     ref)
        else:
            assert got[k] == v


@pytest.fixture
def jax_drawn(monkeypatch):
    from tpuvc_torch.convert import pipeline
    from tpuvc_torch.dsp import world
    monkeypatch.setattr(pipeline, "synthesis_noise", jax_noise)
    monkeypatch.setattr(world, "synthesis_noise", jax_noise)


def test_evaluate_cli_round_trip_matches_jax(setup, jax_drawn):
    """Round-trip mode against tpuvc.cli.evaluate, JAX's noise drawn on
    both sides: the same JSON keys and count, every number within 0.1
    dB, and the MCD < 8 dB (tests/test_end2end.py's bound).  Measured
    (JAX vs port): mean 4.242 vs 4.274 dB, max 5.748 vs 5.751 dB over 4
    utterances."""
    ref, got = _evaluate(setup, "round_trip")
    _agree(ref, got, 0.1)
    assert got["n_utterances"] == 4 and got["mean"] < 8.0


def test_evaluate_cli_conversion_matches_jax(setup, jax_drawn, monkeypatch):
    """Conversion mode against tpuvc.cli.evaluate on the same checkpoint
    parameters, corpus and noise.

    The port's evaluation of the JAX converter's output (its converter's
    ``convert`` answering with the JAX converter's waveforms): every
    number within 0.1 dB.  Measured: within 0.012 dB (gv_ratio_db 4.336
    vs 4.348; mean 14.381 vs 14.376).

    The port's CLI as it is: every number within 0.5 dB.  The two
    converted waveforms agree to 67 dB SNR, but the last frame of a 0.6 s
    utterance decays into its padding, where DIO's derivative events fire
    on rounding-level values: its f0, hence CheapTrick's window and the
    frame's envelope, move, and one frame of 121 carries the difference.
    Measured (JAX vs port): mean 14.381 vs 14.262 dB, mean_dtw 12.592 vs
    12.530, gv_ratio_db 4.336 vs 4.095, ms_highband_ratio_db 3.508 vs
    3.507."""
    from tpuvc.cli.convert import load_converter as jax_load
    from tpuvc_torch.cli import convert as port_convert
    corpus, (jax_run, _) = setup
    ref, got = _evaluate(setup, "conversion")
    _agree(ref, got, 0.5)
    assert got["n_utterances"] == 1 and got["step"] == 3

    jconv, _ = jax_load(jax_run, corpus)
    real = port_convert.load_converter

    def load(*a, **kw):
        conv, step = real(*a, **kw)
        conv.convert = jconv.convert
        return conv, step

    monkeypatch.setattr(port_convert, "load_converter", load)
    _, same = _evaluate(setup, "conversion")
    _agree(ref, same, 0.1)
