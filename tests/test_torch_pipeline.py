"""The port's conversion paths (tpuvc_torch.convert.pipeline) against the
JAX package's batched converter, and the port's boundaries: no JAX and no
JAX package inside it or in chip_smoke.py, the card as its default device,
and no CPU stand-in for the card in chip_smoke.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import make_speech_like
from tpuvc.utils.config import Architecture
from tpuvc.utils.metrics import mcd
from tpuvc_torch.dsp.constants import DEFAULT_WORLD, WorldConfig
from tpuvc_torch.utils import config as port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = WorldConfig(ap_method="nccf")
SEEDS = np.array([5, 9], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run several worker processes on one machine: PyTorch's
    intra-op threads (one per core in each) would contend with the other
    workers on the small shapes here, so each module runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FUSED = dict(conv_impl="pallas", d2s_impl="pallas")


def _slice(cfg, arch_fields=None):
    """Batch 2 x 0.5 s through both converters under ``cfg`` and the
    architecture ``Architecture(**arch_fields)`` from the same params,
    statistics and noise.  JAX: one jit holding make_batch_convert_fn and
    the per-utterance analysis/decode intermediates (one compile)."""
    arch_fields = arch_fields or {}
    from tpuvc.convert.pipeline import (_denormalize_sp, _normalize_sp,
                                        make_batch_convert_fn)
    from tpuvc.dsp.cheaptrick import cheaptrick
    from tpuvc.dsp.constants import WorldConfig as JaxConfig
    from tpuvc.dsp.dio import dio
    from tpuvc.dsp.stonemask import stonemask
    from tpuvc.models.vae import init_params, make_model
    from tpuvc.ops.ulaw import ulaw_encode
    from tpuvc_torch.convert import pipeline as port
    from tpuvc_torch.dsp import world as port_world
    from tpuvc_torch.models import params as port_params
    from tpuvc_torch.ops import ulaw as port_ulaw

    jcfg = JaxConfig(ap_method=cfg.ap_method, f0_method=cfg.f0_method)
    arch = Architecture(**arch_fields)
    model = make_model(arch)
    tree = init_params(model, arch, jax.random.PRNGKey(0))
    xs = np.stack([make_speech_like(k, dur_s=0.5)[0]
                   for k in ("sweep", "transitions")]).astype(np.float32)
    y_trg = np.array([3, 7], np.int32)
    xmin = np.full(513, -10.0, np.float32)
    xmax = np.full(513, 1.0, np.float32)
    mu_s, sd_s = np.array([5.0, 5.1], np.float32), np.ones(2, np.float32)
    mu_t = np.array([5.3, 4.9], np.float32)
    sd_t = np.array([1.0, 1.2], np.float32)
    n_samples = (xs.shape[1] // CFG.hop + 1) * CFG.hop
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.PRNGKey(int(s)), (n_samples,), jnp.float32))
        for s in SEEDS])

    base = make_batch_convert_fn(model, jcfg)

    @jax.jit
    def run(params, xs, y, xmin, xmax, mu_s, sd_s, mu_t, sd_t, seeds):
        wav = base(params, xs, y, xmin, xmax, mu_s, sd_s, mu_t, sd_t, seeds)

        def inter(x, yt):
            f0 = stonemask(x, dio(x))
            sp = cheaptrick(x, f0)
            u, en = _normalize_sp(sp, xmin, xmax)
            z, _ = model.apply(params, u, method=type(model).encode)
            yv = jnp.full((u.shape[0],), yt, jnp.int32)
            uc = model.apply(params, z, yv, method=type(model).decode)
            return f0, sp, _denormalize_sp(uc, en, xmin, xmax)

        f0, sp, sp_c = jax.vmap(inter)(xs, y)
        return wav, ulaw_encode(wav), f0, sp, sp_c

    ref = [np.asarray(a) for a in run(
        tree, *(jnp.asarray(a) for a in (xs, y_trg, xmin, xmax, mu_s, sd_s,
                                         mu_t, sd_t, SEEDS)))]

    t = lambda a: torch.tensor(a)  # noqa: E731
    parch = port_config.Architecture(**arch_fields)
    pmodel = port_params.load_model(parch, port_params.from_flax(
        jax.tree_util.tree_map(np.asarray, tree), parch), device="cpu")
    wav = port.make_batch_convert_fn(pmodel, cfg)(
        t(xs), t(y_trg), t(xmin), t(xmax), t(mu_s), t(sd_s), t(mu_t),
        t(sd_t), t(noise))
    with torch.no_grad():
        f0, sp, _ = port_world.world_features(t(xs), cfg)
        u, en = port._normalize_sp(sp, t(xmin), t(xmax))
        z, _ = pmodel.encode(u.reshape(-1, 513))
        uc = pmodel.decode(z, t(y_trg).long().repeat_interleave(
            f0.shape[1])).reshape(u.shape)
        sp_c = port._denormalize_sp(uc, en, t(xmin), t(xmax))
    got = [wav.numpy(), port_ulaw.ulaw_encode(wav).numpy(), f0.numpy(),
           sp.numpy(), sp_c.numpy()]
    return ref, got


@pytest.fixture(scope="module")
def slice_run():
    """The nccf slice (WorldConfig(ap_method="nccf"))."""
    return _slice(CFG)


@pytest.fixture(scope="module")
def default_run():
    """The DEFAULT_WORLD slice: DIO + StoneMask, group-delay D4C."""
    return _slice(DEFAULT_WORLD)


@pytest.fixture(scope="module")
def fused_run():
    """The fused-kernel configuration: DEFAULT_WORLD (the port always takes
    K7's route; the JAX side takes its scan kernel, run in interpret mode,
    under TPUVC_SCAN=pallas and TPUVC_EVENTS=pallas) and the full-width
    architecture with conv_impl/d2s_impl="pallas" (K8, K9; interpret mode
    in JAX)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUVC_SCAN", "pallas")
        mp.setenv("TPUVC_EVENTS", "pallas")
        return _slice(DEFAULT_WORLD, FUSED)


def _check_f0(run):
    ref, got = run
    fr, fg = ref[2], got[2]
    assert fr.shape == fg.shape
    assert np.mean((fr > 0) == (fg > 0)) >= 0.98
    both = (fr > 0) & (fg > 0)
    assert both.mean() > 0.5
    np.testing.assert_allclose(fg[both], fr[both], rtol=1e-3)


def _check_mcd(run):
    ref, got = run
    for b in range(2):
        assert mcd(got[3][b], ref[3][b], 16000) < 0.1
        assert mcd(got[4][b], ref[4][b], 16000) < 0.1


def _check_snr(run):
    ref, got = run
    assert got[0].shape == ref[0].shape
    assert np.all(np.isfinite(got[0]))
    for b in range(2):
        r, g = ref[0][b].astype(np.float64), got[0][b].astype(np.float64)
        snr = 10 * np.log10(np.sum(r ** 2) / np.sum((g - r) ** 2))
        assert snr >= 40.0, snr


def _check_ulaw(run):
    from tpuvc_torch.ops.ulaw import ulaw_decode
    ref, got = run
    assert got[1].dtype == np.uint8 and got[1].shape == ref[1].shape
    diff = np.abs(got[1].astype(np.int32) - ref[1].astype(np.int32))
    assert np.mean(diff == 0) >= 0.90
    assert np.mean(diff <= 1) >= 0.98
    r, g = ulaw_decode(ref[1]), ulaw_decode(got[1])
    assert 10 * np.log10(np.sum(r ** 2) / np.sum((g - r) ** 2)) >= 30.0


def test_slice_f0(slice_run):
    """Voicing agrees on >= 98% of frames and voiced f0 to 1e-3 relative
    (DIO's event times are bit-exact; FFT rounding can flip a threshold)."""
    _check_f0(slice_run)


def test_slice_spectra_mcd(slice_run):
    """Mel-cepstral distortion between the port's and JAX's envelopes,
    < 0.1 dB both for the analysis and after the model: the gap is the
    JAX side's float32 matmul DFTs (~1e-4 rad matrix phase error) carried
    through a float32 encode/decode.  Measured 0.008-0.018 dB."""
    _check_mcd(slice_run)


def test_slice_waveform_snr(slice_run):
    """Waveform SNR of the port against JAX >= 40 dB with the same noise:
    the envelope gaps above reach the minimum-phase responses, and the
    excitation's float32 phase cumsum is summed in another order; measured
    57-59 dB."""
    _check_snr(slice_run)


def test_slice_ulaw_codes(slice_run):
    """ulaw8 codes: >= 90% identical and >= 98% within one step, and the
    decoded waveforms agree to 30 dB SNR.  mu-law steps are finest at
    zero, so the ~1e-3 waveform gap moves samples near zero crossings by
    many codes (measured: 94-96% identical, 99.1-99.5% within one)."""
    _check_ulaw(slice_run)


def test_default_slice_f0(default_run):
    """DEFAULT_WORLD: the f0 path is the nccf slice's (D4C does not feed
    back): voicing >= 98%, voiced f0 within 1e-3 relative."""
    _check_f0(default_run)


def test_default_slice_spectra_mcd(default_run):
    """DEFAULT_WORLD: MCD < 0.1 dB for the analysis and converted
    envelopes, as for the nccf slice (D4C does not feed the model)."""
    _check_mcd(default_run)


def test_default_slice_waveform_snr(default_run):
    """DEFAULT_WORLD with the same jax-made noise: SNR >= 40 dB.  The
    group-delay aperiodicity agrees within ~1e-3 dB
    (test_torch_dsp.py::test_d4c_group_delay_matches_jax), so the gap is
    the envelope and excitation rounding of the nccf slice."""
    _check_snr(default_run)


def test_default_slice_ulaw_codes(default_run):
    """DEFAULT_WORLD ulaw8 codes, under the nccf slice's bounds."""
    _check_ulaw(default_run)


def test_fused_slice_f0(fused_run):
    """Fused-kernel configuration: voicing >= 98%, voiced f0 within 1e-3
    relative (the fused scans are bit-identical to the ladders)."""
    _check_f0(fused_run)


def test_fused_slice_spectra_mcd(fused_run):
    """Fused-kernel configuration: MCD < 0.1 dB for the analysis and the
    converted envelopes (the fused layers compute what the default ones
    do, float32 here)."""
    _check_mcd(fused_run)


def test_fused_slice_waveform_snr(fused_run):
    """Fused-kernel configuration with the same jax-made noise: waveform
    SNR >= 40 dB, as the default slice."""
    _check_snr(fused_run)


def test_fused_slice_ulaw_codes(fused_run):
    """Fused-kernel configuration ulaw8 codes, under the default slice's
    bounds."""
    _check_ulaw(fused_run)


def _assets():
    from tpuvc_torch.convert.pipeline import ConverterAssets
    return ConverterAssets(
        xmin=np.full(513, -10.0, np.float32),
        xmax=np.full(513, 1.0, np.float32),
        f0_mu=np.array([5.0, 5.3, np.nan], np.float32),
        f0_sigma=np.ones(3, np.float32), speakers=["A", "B", "C"])


@pytest.mark.parametrize("encoding", ["ulaw8", "pcm12", "float32"])
def test_converter_convert_batch(encoding):
    """The host API: ragged lengths come back at their own lengths, and
    each output equals the batched function's output on the same
    per-utterance noise, up to the transfer codec."""
    from tpuvc_torch.convert import pipeline
    from tpuvc_torch.models import params
    arch = port_config.Architecture(y_dim=3)
    model = params.load_model(arch, params.init_params(
        arch, torch.Generator().manual_seed(0), device="cpu"), device="cpu")
    conv = pipeline.Converter(model, _assets(), CFG, bucket_s=0.25,
                              transfer_encoding=encoding, device="cpu")
    xs = [make_speech_like(k, dur_s=d)[0].astype(np.float32)
          for k, d in (("sweep", 0.3), ("vibrato", 0.45))]
    ys = conv.convert_batch(xs, ["A", "B"], ["B", "A"], seed=4)
    assert [len(y) for y in ys] == [len(x) for x in xs]
    n_samples = (8000 // 80 + 1) * 80      # two 0.25 s buckets
    t = torch.tensor
    rows = np.stack([np.pad(x, (0, 8000 - len(x))) for x in xs])
    want = pipeline.make_batch_convert_fn(model, CFG)(
        t(rows), t([1, 0]), t(conv.assets.xmin), t(conv.assets.xmax),
        t([5.0, 5.3]), t([1.0, 1.0]), t([5.3, 5.0]), t([1.0, 1.0]),
        pipeline.synthesis_noise([4, 5], n_samples, "cpu")).numpy()
    step = {"ulaw8": 0.05, "pcm12": 1.0 / 2047, "float32": 0.0}[encoding]
    for i, y in enumerate(ys):
        assert np.all(np.isfinite(y))
        w = want[i, :len(y)]
        if encoding != "float32":          # the codecs clip to [-1, 1]
            w = np.clip(w, -1.0, 1.0)
        np.testing.assert_allclose(y, w, atol=step + 1e-6)
    with pytest.raises(ValueError, match="no f0"):
        conv.convert_batch(xs[:1], ["C"], ["A"])


def test_converter_harvest_path_and_default_device():
    """Converter with WorldConfig(f0_method="harvest") converts on the
    CPU when asked (outputs finite at their own lengths, voiced), and the
    Converter defaults to the card: without one it raises instead of
    falling back."""
    import inspect
    from tpuvc_torch.convert import pipeline
    from tpuvc_torch.models import params
    arch = port_config.Architecture(y_dim=3)
    model = params.load_model(arch, params.init_params(
        arch, torch.Generator().manual_seed(0), device="cpu"), device="cpu")
    cfg = WorldConfig(f0_method="harvest")
    conv = pipeline.Converter(model, _assets(), cfg, bucket_s=0.25,
                              device="cpu")
    xs = [make_speech_like(k, dur_s=d)[0].astype(np.float32)
          for k, d in (("vibrato", 0.4), ("sweep", 0.3))]
    ys = conv.convert_batch(xs, ["A", "B"], ["B", "A"], seed=1)
    assert [len(y) for y in ys] == [len(x) for x in xs]
    assert all(np.all(np.isfinite(y)) and np.std(y) > 1e-3 for y in ys)
    assert (inspect.signature(pipeline.Converter).parameters["device"]
            .default == "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pipeline.Converter(model, _assets(), cfg)


def test_port_imports_no_jax():
    """Every tpuvc_torch module, chip_smoke.py and every module
    chip_smoke.py imports (inside its functions too) import without jax,
    jaxlib, flax, optax, orbax or any module of the JAX package tpuvc (the
    card's machine has none of them)."""
    code = (
        "import ast, pkgutil, sys, importlib, tpuvc_torch\n"
        "for m in pkgutil.walk_packages(tpuvc_torch.__path__, "
        "'tpuvc_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "n = sum(m.startswith('tpuvc_torch') for m in sys.modules)\n"
        "import chip_smoke\n"
        "tree = ast.parse(open(chip_smoke.__file__).read())\n"
        "for node in ast.walk(tree):\n"
        "    if isinstance(node, ast.Import):\n"
        "        for a in node.names: importlib.import_module(a.name)\n"
        "    elif isinstance(node, ast.ImportFrom):\n"
        "        mod = importlib.import_module(node.module)\n"
        "        for a in node.names:\n"
        "            if not hasattr(mod, a.name):\n"
        "                importlib.import_module(node.module + '.' + a.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tpuvc')]\n"
        "print(n, bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    # 84 modules since the retired benches went (train/ is 6 of them,
    # parallel/ 5, bench/ 4, quality/ 7): a missing package falls below
    # the bound
    assert int(out.stdout.split()[0]) >= 80


def test_chip_smoke_refuses_the_cpu(tmp_path):
    """On a machine without a CUDA card chip_smoke.py exits non-zero with a
    clear message, prints no "ok" line and builds nothing; alone in a
    directory it fails too."""
    import shutil
    build = os.path.join(ROOT, "build", "tpuvc_torch")
    before = set(os.listdir(build)) if os.path.isdir(build) else set()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr
    after = set(os.listdir(build)) if os.path.isdir(build) else set()
    assert after == before
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=120)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout


@pytest.mark.parametrize("cap", [810.0, 1056.0])
def test_chip_smoke_smooth_library_matches_plain(cap):
    """chip_smoke.py's library yardstick for the box smoothing (one
    depthwise F.conv1d over the mirror-extended rows) computes the same
    function as box_smooth_plain: rtol 1e-5, atol 1e-6 of the largest
    value (the convolution sums the taps in another order)."""
    import chip_smoke
    from tpuvc_torch.ops.smooth import box_smooth_plain
    rng = np.random.default_rng(4)
    ps = torch.from_numpy((10.0 ** rng.uniform(-6, 0, (23, 513))).astype(
        np.float32))
    width = torch.from_numpy(rng.uniform(3.0, cap + 200.0, 23).astype(
        np.float32))
    got = chip_smoke.smooth_conv1d(ps, width, 16000, 1024, cap)()[0]
    ref = box_smooth_plain(ps, width, 16000, 1024, cap)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6 * ref.abs().max().item())


def test_chip_smoke_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's kernel, serve and rate phases run end to end on the
    CPU at a small size for every path (harvest_decim2 included: its K1,
    K7 and K6 sites in phase 3), the fused path's streaming and
    cli.analyze drives included (every wrapper takes its plain version, so
    nothing launches and the kernel/plain errors are exactly 0), and its
    JSON record names all twelve kernels with every key."""
    import chip_smoke
    from tpuvc_torch.ops._build import KERNEL_NAMES
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn: float("nan"))
    cpu = torch.device("cpu")
    state = chip_smoke.build_state()
    kern = chip_smoke.phase_kernels(
        cpu, state, dur_s=0.5,
        batches={"default": 1, "harvest": 1, "harvest_decim2": 1},
        two_pass_batch=1)
    assert [k for k, _, _, _ in chip_smoke.KERNELS] == list(kern)
    assert all(r["max_abs_err"] == 0.0 for v in kern.values() for r in v)
    assert len(kern["events"]) == 3 and len(kern["smooth"]) == 3
    assert len(kern["window"]) == 2
    assert kern["window"][0]["two_pass_frames"] == 0
    assert kern["window"][1]["two_pass_frames"] > 0
    # the decim-2 bank: half of Harvest's 152 channels, at the same slots
    assert kern["events"][2]["shape"][0][0] == 76
    assert kern["events"][1]["shape"][0][0] == 152
    assert len(kern["refine"]) == 2
    assert len(kern["scan"]) == 3 and len(kern["conv"]) == 5
    assert len(kern["d2s"]) == 3
    # the contour kernel at DIO's 7 candidates and Harvest's 10, both
    # passes: 2N dependent steps a row
    assert [r["shape"][1][2] for r in kern["extend"]] == [7, 10]
    assert all(r["dependent_steps"] == 2 * r["shape"][0][1]
               for r in kern["extend"])
    # K12 on Harvest's 152 channels and the decim-2 bank's 76, bound by
    # the bytes of the tracks
    assert [r["shape"][0][1] for r in kern["merge"]] == [152, 76]
    assert all(r["bound_by"] == "bytes" for r in kern["merge"])
    assert kern["conv"][4]["bound_by"] == "operations"
    assert kern["d2s"][0]["bound_by"] == "bytes"
    # K11 at the default model's ten sites: the encoder's five, the
    # dense_norm and the decoder's four steps, every one bound by its bytes
    assert [r["site"] for r in kern["norm"]] == list(chip_smoke.NORM_SITES)
    assert [r["shape"][0][-1] for r in kern["norm"]] == [
        16, 32, 64, 128, 256, 2432, 128, 64, 32, 16]
    assert all(r["bound_by"] == "bytes" and r["library_ms"] is not None
               for r in kern["norm"])
    for path in chip_smoke.PATHS:
        assert "norm" in chip_smoke.path_kernels(path), path
    launches = {}
    for path in chip_smoke.PATHS:
        conv, launches[path], snr, transfer = chip_smoke.phase_serve(
            path, cpu, state, durs=(0.6, 1.1))
        # nothing launches on the CPU, the model's K11 included
        assert launches[path] == dict.fromkeys(KERNEL_NAMES, 0)
        assert (snr is None) == (path == "nccf")
        # the default path alone checks ulaw8 and pcm12 against float32
        assert (transfer is None) == (path != "default")
        if transfer is not None:
            assert transfer["ulaw8"] >= 30.0 and transfer["pcm12"] >= 50.0
        if path == "fused":
            entry = chip_smoke.phase_entry_points(conv, cpu)
            assert entry["analyze_launches"] == dict.fromkeys(KERNEL_NAMES, 0)
        rate = chip_smoke.phase_rate(
            path, conv, "cpu", cpu, batch=2, dur_s=0.5,
            budget_batch=3 if path == "harvest" else None)
        assert rate["audio_s_per_s"] > 0 and rate["profile"] is None
        if path == "nccf":
            assert rate["stages_s"]["d4c_nccf"] > 0
    record = chip_smoke.kernels_record(kern, launches)["kernels"]
    assert [r["name"] for r in record] == list(kern)
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "b2b_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms"}
    assert all(keys <= set(r) for r in record)
    # the contour kernel is bound by its chain of dependent steps, which
    # has no time of its own: its bytes and operations are a side key
    for r in record:
        if r["name"] == "extend":
            assert r["bound_ms"] is None and r["throughput_bound_ms"] > 0
            assert r["bound_by"] == "latency (2N dependent steps)"
        else:
            assert r["bound_ms"] > 0
    for r in record:
        assert os.path.exists(os.path.join(ROOT, r["source"]))
