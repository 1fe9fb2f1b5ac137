"""The Parallel WaveGAN vocoder (``tpuvc_torch/models/pwg.py``) and the
benchmark's configuration that serves it (``vawgan-vcc2016-pwg``), with
the four-card corpus cell's driver, on the CPU: the generator and its
conditioning against the plain reference (``benchmark/reference/pwg.py``)
on seeded weights at cut widths; the upsampler's length; the cell through
the harness, correct, and its control not; the configuration against the
default one; the ``vc.vocode`` spans; the two new readers; a converter
without a vocoder against the path it had; ``cli.convert
--vocoder-checkpoint``; and the mesh cell's driver over four CPU
shards."""

import copy
import os
import types

import numpy as np
import pytest
import torch

from benchmark import common, control, flops_pwg, generate, readers, run
from benchmark import spans, trace
from benchmark.drivers import corpus, corpus_pwg
from benchmark.reference import pwg as ref_pwg
from benchmark.reference.convert import World
from benchmark.tests import small
from tpuvc_torch.convert import pipeline
from tpuvc_torch.dsp.constants import DEFAULT_WORLD
from tpuvc_torch.models import pwg

CELL = "vawgan-vcc2016-pwg.corpus"
MESH = "vawgan-vcc2016.corpus-mesh4"
CONFIG = common.load_json("configs", "vawgan-vcc2016-pwg")
# the vocoder's widths cut for the CPU (at full width the stack costs ~21
# GFLOP an utterance of 0.5 s): 6 layers in 2 stacks, 8 channels
SMALL = {**CONFIG["vocoder"], "layers": 6, "stacks": 2,
         "residual_channels": 8, "gate_channels": 16, "skip_channels": 8}
CUTS = {"six_layers": SMALL,
        "one_stack_k5": {**SMALL, "layers": 4, "stacks": 1,
                         "kernel_size": 5, "residual_channels": 4,
                         "gate_channels": 12, "skip_channels": 6,
                         "aux_context_window": 1}}
READERS = ("mfu_pct.pwg", "vocode_idle_ms_per_call.corpus")
SEED = 2**31 + 2929


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the machine: one PyTorch thread
    each (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(voc: dict, seed: int = SEED) -> dict:
    shapes = {k: v.shape for k, v in ref_pwg.ParallelWaveGAN(
        ref_pwg.Spec(voc)).state_dict().items()}
    return generate.weights(seed, "vocoder", shapes, "cpu")


def _inputs(n_frames: int, hop: int, rows: int = 2):
    g = torch.Generator().manual_seed(n_frames)
    c = torch.randn((rows, 80, n_frames), generator=g) * 3.0 - 6.0
    return torch.randn((rows, n_frames * hop), generator=g), c


def _db(got, want) -> float:
    return float(10 * torch.log10(((got - want) ** 2).sum()
                                  / (want ** 2).sum()))


@pytest.mark.parametrize("cut", list(CUTS))
def test_the_generator_matches_the_reference(cut):
    """Seeded weights in both.  In float32 the port computes what the
    reference computes: the same convolutions, the upsampler's time
    filter as a ``conv1d`` over the channels as rows where the reference
    runs the published ``conv2d``, and in-place adds: within 1e-5 of the
    output's largest value (float32 sums in another order).  In bf16
    (every activation rounded to 8 bits of mantissa, the serving type)
    it stays 25 dB under the output's energy: at these widths it reads
    -34 dB."""
    voc = CUTS[cut]
    state = _state(voc)
    want_model = ref_pwg.make_vocoder(ref_pwg.Spec(voc), state, "cpu")
    spec = pwg.PWGSpec.from_json(voc)
    z, c = _inputs(23, spec.hop)
    want = want_model(z, c)
    got = pwg.load_vocoder(spec, state, "cpu")(z, c)
    assert got.dtype == torch.float32 and got.shape == z.shape
    assert torch.allclose(got, want, rtol=0,
                          atol=1e-5 * float(want.abs().max()))
    half = pwg.load_vocoder(spec, state, "cpu", "bfloat16")(z, c)
    assert half.dtype == torch.float32
    assert _db(half, want) < -25.0


def test_the_conditioning_matches_the_reference():
    """Log mel bands of the envelope, log f0 where voiced, the voicing
    flag and the mean aperiodicity: the same float32 operations on the
    same bank (the banks agree within float32 rounding of float64
    edges), so within 1e-6 of each value."""
    g = torch.Generator().manual_seed(3)
    f0 = torch.rand((2, 9), generator=g) * 300.0
    f0[:, ::3] = 0.0
    sp = torch.rand((2, 9, 513), generator=g) ** 4 * 1e-2
    sp[1, 4] = 0.0                          # a silent frame: the floor
    ap = torch.rand((2, 9, 513), generator=g)
    spec = pwg.PWGSpec()
    got = pwg.aux_features(f0, sp, ap, DEFAULT_WORLD, spec)
    want = ref_pwg.aux_features(f0, sp, ap, World(), ref_pwg.Spec(
        CONFIG["vocoder"]))
    assert got.shape == want.shape == (2, 80, 9)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    assert float(got[1, :77, 4].max()) == pytest.approx(np.log(1e-10))
    assert torch.equal(got[:, 78], (f0 > 0).float())
    bank = pwg.mel_bank(16000, 1024, 77, 80.0, 7600.0, torch.device("cpu"))
    np.testing.assert_allclose(bank.numpy(), ref_pwg.mel_bank(
        16000, 1024, 77, 80.0, 7600.0), rtol=0, atol=1e-7)


@pytest.mark.parametrize("samples", [801, 8001, 12345, 16003])
def test_the_upsampler_gives_the_noise_length(samples):
    """An utterance of an odd number of samples T has T // hop + 1 frames
    and T // hop + 1 hops of noise: the upsampling net stretches the
    frames to exactly the noise's length, and the waveform has it."""
    spec = pwg.PWGSpec.from_json(SMALL)
    model = pwg.load_vocoder(spec, _state(SMALL), "cpu")
    n = samples // DEFAULT_WORLD.hop + 1
    z, c = _inputs(n, spec.hop, rows=1)
    w = spec.aux_context_window
    rows = torch.nn.functional.pad(c, (w, w), mode="replicate")
    up = model.upsample_net(rows.transpose(1, 2).contiguous())
    assert up.shape == (1, z.shape[-1], 80) and z.shape[-1] >= samples
    assert model(z, c).shape == z.shape
    with pytest.raises(ValueError):
        model(z[:, 1:], c)


def test_weight_norm_is_folded_on_load():
    """A trained generator's weight-normed pairs load as the weights
    ``torch.nn.utils.weight_norm`` computes from them."""
    spec = pwg.PWGSpec.from_json(SMALL)
    state = _state(SMALL)
    normed = {}
    for k, v in state.items():
        if k.endswith(".weight") and v.dim() >= 2:
            g = torch.rand((v.shape[0],) + (1,) * (v.dim() - 1)) + 0.5
            normed[k + "_g"], normed[k + "_v"] = g, v * 3.0
        else:
            normed[k] = v
    got = pwg.load_vocoder(spec, normed, "cpu").state_dict()
    v = normed["conv_layers.0.conv1x1_out.weight_v"]
    conv = torch.nn.utils.weight_norm(torch.nn.Conv1d(v.shape[1],
                                                      v.shape[0], 1))
    with torch.no_grad():
        conv.weight_g.copy_(normed["conv_layers.0.conv1x1_out.weight_g"])
        conv.weight_v.copy_(v)
        conv(torch.zeros(1, v.shape[1], 1))
    assert torch.allclose(got["conv_layers.0.conv1x1_out.weight"],
                          conv.weight, rtol=1e-6, atol=1e-7)


def test_the_operation_count_is_the_generators_convolutions():
    """``flops_pwg.per_sample`` is 2 K Cin Cout per output position of
    every convolution of the published generator (the plain reference's
    ``Conv1d`` and ``Conv2d`` modules, counted by hooks at cut widths),
    over the samples it makes, and 2.59 M a sample at v1's widths."""
    model = ref_pwg.make_vocoder(ref_pwg.Spec(SMALL), _state(SMALL), "cpu")
    ops = []

    def count(m, args, out):
        ops.append(2 * m.weight[0].numel() * m.weight.shape[0]
                   * out[:, 0].numel())

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)):
            m.register_forward_hook(count)
    z, c = _inputs(7, pwg.PWGSpec.from_json(SMALL).hop, rows=1)
    model(z, c)
    layers = SMALL["layers"]
    assert len(ops) == 1 + 4 * layers + 2 + 1 + len(SMALL["upsample_scales"])
    assert sum(ops) / z.shape[-1] == pytest.approx(
        flops_pwg.per_sample(SMALL), rel=1e-12)
    full = CONFIG["vocoder"]
    assert flops_pwg.stack_per_sample(full) == (
        2 * 64 + 30 * (2 * 3 * 64 * 128 + 2 * 80 * 128 + 2 * 2 * 64 * 64)
        + 2 * (64 * 64 + 64))
    assert flops_pwg.per_sample(full) == pytest.approx(2.59e6, rel=1e-3)


def _overrides() -> dict:
    return {**small.overrides(CELL), "config_overrides": {"vocoder": SMALL}}


def test_the_cell_is_correct_and_its_control_is_not():
    """The harness's PWG driver at a small traffic size, the vocoder's
    widths cut (the VAW-GAN and the analysis at full width): the window
    is correct against the plain reference and reports the corpus cells'
    end-to-end metrics; the control (model and vocoder in fp8, the
    features through bf16) misses a limit on the same sample, where the
    program keeps both."""
    out = run.execute(CELL, SEED, 0.3, False, device="cpu", **_overrides())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}
    lim = common.load_json("workloads", CELL)["limits"]
    r = control.readings(CELL, SEED + 1, 0.2, "cpu", **_overrides())
    assert set(r["program"]) == set(r["control"]) == set(lim)
    assert all(v <= lim[k] for k, v in r["program"].items()), r
    assert any(v > lim[k] for k, v in r["control"].items()), r


def test_the_configuration_differs_from_the_default_in_its_vocoder_only():
    base = common.load_json("configs", "vawgan-vcc2016")
    cfg = copy.deepcopy(CONFIG)
    voc = cfg.pop("vocoder")
    assert "vocoder" not in base
    assert cfg["reduced"] == [] and "1910.11480" in cfg["source"]
    assert len(cfg["assumed"]) > len(base["assumed"])
    for k in ("name", "source", "description", "assumed"):
        cfg.pop(k), base.pop(k)
    assert cfg == base
    # parallel_wavegan.v1's generator widths, all 30 layers; the scales
    # multiply to the analysis hop
    spec = pwg.PWGSpec.from_json(voc)
    assert spec == pwg.PWGSpec()
    assert (spec.layers, spec.stacks, spec.residual_channels,
            spec.gate_channels, spec.skip_channels, spec.aux_channels,
            spec.kernel_size, spec.aux_context_window) == (
        30, 3, 64, 128, 64, 80, 3, 2)
    assert spec.hop == DEFAULT_WORLD.hop == 80
    entry, = (c for c in common.benchmark_spec()["configs"]
              if c["name"] == "vawgan-vcc2016-pwg")
    assert (entry["source"], entry["reduced"], entry["file"]) == (
        CONFIG["source"], [], "benchmark/configs/vawgan-vcc2016-pwg.json")
    with pytest.raises(ValueError):
        pwg.PWGSpec.from_json({**voc, "upsample_net": "UpsampleNetwork"})


def test_the_cells_report_their_metrics():
    spec = common.benchmark_spec()
    names = {m["name"] for m in common.cell_metrics(spec, CELL,
                                                    "per_layer")}
    default = {m["name"] for m in common.cell_metrics(
        spec, "vawgan-vcc2016.corpus", "per_layer")}
    # mfu_pct.corpus counts the VAW-GAN's operations alone: the PWG cell
    # reads the whole step's share in mfu_pct.pwg
    assert names == (default - {"mfu_pct.corpus"}) | set(READERS)
    for m in common.cell_metrics(spec, CELL, "per_layer"):
        assert m["moves"] == "audio_s_per_s"
        assert callable(readers.find(m["name"]))
    mesh = {m["name"] for m in common.cell_metrics(spec, MESH, "per_layer")}
    assert mesh == {"launches_per_audio_s.corpus", "prep_ms_per_call.corpus"}
    cells = {w["name"]: w for w in spec["workloads"]}
    assert (cells[CELL]["config"], cells[CELL]["chips"]) == (
        "vawgan-vcc2016-pwg", 1)
    assert (cells[MESH]["config"], cells[MESH]["chips"]) == (
        "vawgan-vcc2016", 4)
    for cell, kind in ((CELL, "corpus_pwg"), (MESH, "corpus_mesh")):
        wl = common.load_json("workloads", cell)
        assert wl["traffic"] == cells[cell]["traffic"]
        assert wl["traffic_params"]["kind"] == kind
    assert sum(w["chips"] == 4 for w in spec["workloads"]) == 1


@pytest.fixture(scope="module")
def vocoded():
    """One conversion of two utterances through a converter with the
    cut vocoder, traced by the harness's own tracer (host ranges only on
    the CPU), with the converter and its arguments."""
    r = run.Run(CELL, SEED, "cpu", small.CORPUS, {"vocoder": SMALL})
    state = corpus.generator_weights(r, r.config)
    assets = generate.assets(r.seed, r.config)
    conv = corpus_pwg.make_converter(r, state, _state(SMALL), assets,
                                     "float32")
    g = np.random.default_rng(0)
    xs = [(0.1 * g.standard_normal(n)).astype(np.float32)
          for n in (4001, 5555)]
    args = (xs, ["SF1", "TM1"], ["TM3", "SF2"])
    tracer = trace.Tracer(True, float("inf"))
    tracer.start()
    y = conv.convert_batch(*args, seed=[5, 6])
    tracer.stop(types.SimpleNamespace(counters={}, spans={}))
    tracer.finish()
    return conv, args, y, tracer.summary


def _ranges(summary, name) -> list[tuple[int, int]]:
    return sorted(zip(*(v.tolist() for v in spans.intervals(summary,
                                                             name))))


def test_the_vocode_spans_nest_in_vc_vocode(vocoded):
    """A profiled call with a vocoder opens ``vc.vocode`` where
    ``vc.synth`` was, after ``vc.model``, and inside it
    ``vc.vocode.aux``, ``vc.vocode.upsample`` and ``vc.vocode.stack`` one
    after another; the waveforms are the unprofiled call's, bit for
    bit."""
    conv, args, y, s = vocoded
    assert all(np.array_equal(a, b)
               for a, b in zip(y, conv.convert_batch(*args, seed=[5, 6])))
    assert [len(a) for a in y] == [4001, 5555]
    assert _ranges(s, "vc.synth") == []
    (vs, ve), = _ranges(s, "vc.vocode")
    (_, me), = _ranges(s, "vc.model")
    assert me <= vs
    inner = [_ranges(s, f"vc.vocode.{k}") for k in ("aux", "upsample",
                                                    "stack")]
    assert all(len(r) == 1 for r in inner)
    flat = [r[0] for r in inner]
    assert all(vs <= a < b <= ve for a, b in flat)
    assert all(b <= a2 for (_, b), (a2, _) in zip(flat, flat[1:]))


def _with_device(summary, device) -> trace.Summary:
    host = list(zip(summary.host_names, summary.host_start.tolist(),
                    (summary.host_end - summary.host_start).tolist()))
    (lo, hi), = _ranges(summary, "vc.convert_batch")
    return trace.Summary(device(lo, hi), host, (summary.lo, summary.hi))


def _read(name, summary, config=CONFIG, counters=None):
    return readers.find(name)(types.SimpleNamespace(
        summary=summary, counters=counters or {}, spans={}, config=config))


def test_the_readers_read_the_idle_time_and_the_whole_steps_share(vocoded):
    """With the card busy only after the call, every nanosecond inside
    ``vc.vocode`` is idle; busy all through the call, none.  The share
    is the model's and the vocoder's operations over the window at the
    bf16 peak."""
    s = _with_device(vocoded[3], lambda lo, hi: [("k", hi, 1)])
    (a, b), = _ranges(s, "vc.vocode")
    assert _read(READERS[1], s) == (b - a) / 1e6
    s = _with_device(vocoded[3], lambda lo, hi: [("k", lo, hi - lo)])
    assert _read(READERS[1], s) == 0.0
    counters = {"frames": 1000.0, "audio_s": 4.0}
    arch = readers.architecture(CONFIG, "serve_dtype")
    ops = (1000.0 * readers.flops.generator_per_frame(arch)
           + 4.0 * 16000 * flops_pwg.per_sample(CONFIG["vocoder"]))
    assert _read(READERS[0], s, counters=counters) == pytest.approx(
        100.0 * ops / (s.window_s * readers.peaks.BF16_OPS_PER_S))


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_none_without_device_events(name, vocoded):
    counters = {"frames": 1000.0, "audio_s": 4.0}
    assert _read(name, None, counters=counters) is None
    # the CPU: host ranges and no card
    assert _read(name, vocoded[3], counters=counters) is None
    # a converter without a vocoder: no span, no vocoder block
    plain = trace.Summary([("k", 0, 10)], [("vc.convert_batch", 0, 100),
                                            ("vc.synth", 10, 50)], (0, 100))
    assert _read(name, plain, config=common.load_json(
        "configs", "vawgan-vcc2016"), counters=counters) is None


def test_a_converter_without_a_vocoder_is_the_path_it_was(vocoded):
    """Without a vocoder the batched converter is, bit for bit, the
    composition it was before vocoders: analysis, normalise, encode,
    decode, de-normalise, the f0 transform, WORLD's synthesis.  With
    one, the same rows give waveforms of the same length that differ."""
    from tpuvc_torch.convert.f0 import convert_f0
    from tpuvc_torch.dsp.synthesis import synthesis_noise, synthesize
    from tpuvc_torch.dsp.world import world_features
    conv = vocoded[0]
    model, cfg = conv.model, conv.cfg
    g = torch.Generator().manual_seed(1)
    xs = torch.randn((2, 8000), generator=g) * 0.1
    ti = torch.tensor([3, 7])
    stats = [torch.tensor(v, dtype=torch.float32) for v in (
        [5.0, 4.8], [0.1, 0.12], [4.9, 5.2], [0.09, 0.11])]
    noise = synthesis_noise([1, 2], (8000 // cfg.hop + 1) * cfg.hop, "cpu")
    with torch.no_grad():
        f0, sp, ap = world_features(xs, cfg)
        n = f0.shape[1]
        u, en = pipeline._normalize_sp(sp, conv._xmin, conv._xmax)
        z_mu, _ = model.encode(u.reshape(2 * n, -1))
        u_conv = model.decode(z_mu, ti.repeat_interleave(n)).reshape(
            2, n, -1)
        sp_conv = pipeline._denormalize_sp(u_conv, en, conv._xmin,
                                           conv._xmax)
        want = synthesize(convert_f0(f0, *stats), sp_conv, ap, noise,
                          fs=cfg.fs, hop=cfg.hop, fft_size=cfg.fft_size)
    args = (xs, ti, conv._xmin, conv._xmax, *stats, noise)
    got = pipeline.make_batch_convert_fn(model, cfg)(*args)
    assert torch.equal(got, want)
    voiced = pipeline.make_batch_convert_fn(model, cfg,
                                            vocoder=conv.vocoder)(*args)
    assert voiced.shape == want.shape and not torch.equal(voiced, want)


def test_streaming_refuses_a_vocoder(vocoded):
    from tpuvc_torch.convert.streaming import (MultiStreamConverter,
                                               StreamingConverter)
    conv = vocoded[0]
    with pytest.raises(ValueError, match="vocoder"):
        StreamingConverter(conv, "SF1", "TM3")
    with pytest.raises(ValueError, match="vocoder"):
        MultiStreamConverter(conv, [("SF1", "TM3")])


def test_cli_convert_takes_a_vocoder_checkpoint(tmp_path):
    """``cli.convert --vocoder-checkpoint`` on a VAE run (a seeded
    init, no training) converts one utterance with a saved seeded
    generator: the WAV has the utterance's length, and is what the loaded
    converter with that vocoder gives, not what WORLD's synthesis
    gives."""
    from tpuvc_torch.cli import convert as cli
    from tpuvc_torch.data.analyze_corpus import analyze_corpus
    from tpuvc_torch.data.synthetic import make_corpus
    from tpuvc_torch.io import corpus as corpus_io
    from tpuvc_torch.io.wav import read_wav
    from tpuvc_torch.models import params
    from tpuvc_torch.train import steps
    from tpuvc_torch.train.checkpoint import Checkpointer
    from tpuvc_torch.utils.config import Architecture
    root = str(tmp_path / "corpus")
    defs = {"SA": (120.0, (500.0, 1500.0), -4.0),
            "SB": (200.0, (700.0, 2200.0), -6.0)}
    make_corpus(root, n_train=1, n_test=1, dur_s=0.4, seed=0,
                speaker_defs=defs)
    analyze_corpus(root, DEFAULT_WORLD, splits=(corpus_io.TRAIN_SPLIT,),
                   device="cpu")
    arch = Architecture.from_json({
        **small.train_config()["architecture"], "model": "VAE",
        "trainer": "VAETrainer", "y_dim": 2})
    rundir = str(tmp_path / "run")
    os.makedirs(rundir)
    arch.save(os.path.join(rundir, "architecture.json"))
    gen = params.init_params(arch, torch.Generator().manual_seed(0), "cpu")
    Checkpointer(os.path.join(rundir, "ckpt")).save(
        1, steps.vae_state(arch, gen, "cpu"))
    path = str(tmp_path / "pwg.pt")
    pwg.save(path, pwg.PWGSpec.from_json(SMALL), _state(SMALL))
    out, = cli.main(["--src", "SA", "--trg", "SB", "--checkpoint", rundir,
                     "--corpus", root, "--output", str(tmp_path / "out"),
                     "--vocoder-checkpoint", path, "--device", "cpu"])
    wav = corpus_io.list_wavs(root, corpus_io.TEST_SPLIT, "SA")[0]
    x, _ = read_wav(wav)
    y, _ = read_wav(out)
    assert len(y) == len(x) and np.isfinite(y).all()
    conv, _ = cli.load_converter(rundir, root, device="cpu",
                                 vocoder_checkpoint=path)
    world, _ = cli.load_converter(rundir, root, device="cpu")
    want = conv.convert(x.astype(np.float32), "SA", "SB")
    # the WAV holds the waveform clipped to [-1, 1], truncated to 16 bits
    # at a scale of 32767 and read back at 1/32768: two steps at most
    assert np.abs(y - np.clip(want, -1, 1)).max() <= 2.0 / 32767
    assert not np.allclose(want, world.convert(x.astype(np.float32), "SA",
                                               "SB"))
    with pytest.raises(ValueError, match="vocoder"):
        cli.main(["--src", "SA", "--trg", "SB", "--checkpoint", rundir,
                  "--corpus", root, "--output", str(tmp_path / "out2"),
                  "--vocoder-checkpoint", path, "--streaming",
                  "--device", "cpu"])


def test_the_mesh_cell_is_correct_on_four_cpu_shards():
    """The four-card corpus driver over a mesh of four CPU shards, at a
    small size (four utterances a request, one a shard): each shard's
    rows are checked against their own reference call at the request's
    padded length."""
    tr = {**small.CORPUS, "utts_per_request": 4, "pool": 8}
    out = run.execute(MESH, SEED + 2, 0.3, False, device="cpu",
                      traffic_overrides=tr)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["device"]["count"] == 4
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}


def test_the_reference_holds_nothing_of_the_port_and_restores_tf32():
    assert common.reference_leaks() == []
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with ref_pwg.strict_float32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before
