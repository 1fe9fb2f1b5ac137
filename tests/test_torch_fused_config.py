"""The benchmark's fused-route configuration (``vawgan-vcc2016-fused``:
the encoder's layers as K8, ``ops/conv.py``, and the decoder's
depth-to-space steps as K9, ``ops/d2s.py``) on the CPU, where both
wrappers take their plain versions: the port's model on that route
against the plain reference (``benchmark/reference/model.py``), the
configuration through the serving path and the harness, the count of
``benchmark/roofline/conv_d2s.py`` against ``chip_smoke.py:bound_of``,
and the model's spans."""

import copy
import math
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from benchmark import common, kernels, peaks, run
from benchmark.reference import arch as ref_arch
from benchmark.reference import convert as ref_convert
from benchmark.reference import model as ref_model
from benchmark.tests import small
from tpuvc_torch.models import vae
from tpuvc_torch.models.params import load_model
from tpuvc_torch.utils import config as port_config

CELL = "vawgan-vcc2016-fused.corpus"
CONFIG = common.load_json("configs", "vawgan-vcc2016-fused")
ROOFLINE = common.load_module("roofline", "conv_d2s")
ROUTES = {"conv_impl": "pallas", "d2s_impl": "pallas"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the machine: one PyTorch thread
    each (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrow(arch: dict) -> dict:
    """The configuration's architecture with its widths cut (this test
    only: the benchmark runs the published ones)."""
    a = copy.deepcopy(arch)
    a["encoder"]["output"] = [4, 8, 8, 16, 16]
    a["generator"]["output"] = [16, 8, 8, 4, 1]
    a["z_dim"] = a["y_emb_dim"] = 8
    return a


WIDTHS = {"narrow": _narrow(CONFIG["architecture"]),
          "published": CONFIG["architecture"]}


def _state(arch, seed: int) -> dict:
    """Seeded random weights, LayerNorm scales and biases included (the
    benchmark's Flax draw leaves those at 1 and 0)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in ref_model.VAWGAN(arch).state_dict().items():
        t = torch.randn(v.shape, generator=g)
        if "norm" in k and k.endswith("weight"):
            t = 1.0 + 0.1 * t
        elif k.endswith("bias"):
            t = 0.1 * t
        elif v.dim() > 1 and not k.endswith("embed"):
            t = t / math.sqrt(v[0].numel())
        out[k] = t
    return out


def _models(arch: dict, dtype: str, seed: int):
    """The plain reference, the port on the fused route and the control
    (the reference with fp8 operands), one state dict."""
    ra = ref_arch.Architecture.from_json({**arch, "compute_dtype": dtype})
    state = _state(ra, seed)
    port = load_model(port_config.Architecture.from_json(
        {**arch, "compute_dtype": dtype}), state, "cpu")
    assert port.encoder.stack.fused and port.decoder.fused_d2s
    return (ref_convert.make_model(ra, state, "cpu"), port,
            ref_convert.make_model(ra, state, "cpu", fp8=True))


def _frames(seed: int, n: int = 32):
    g = torch.Generator().manual_seed(100 + seed)
    return (torch.rand(n, 513, generator=g) * 2 - 1,
            torch.randint(0, 10, (n,), generator=g))


def _rms(t: torch.Tensor) -> float:
    return float(t.float().pow(2).mean().sqrt())


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_the_fused_route_is_the_reference_in_float32(widths):
    """In float32 the routes pick kernels, not arithmetic: the wrappers'
    plain versions are the reference's float32 operations, so encoder and
    decoder agree to 1e-5 of the output's scale (float32 rounding of a
    reordered sum would show there; none does on the CPU)."""
    ref, port, _ = _models(WIDTHS[widths], "float32", seed=0)
    u, y = _frames(0)
    with torch.no_grad():
        (rm, rl), (pm, pl) = ref.encode(u), port.encode(u)
        rx, px = ref.decode(rm, y), port.decode(rm, y)
    for got, want in ((pm, rm), (pl, rl), (px, rx)):
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_the_fused_route_in_bf16_rounds_no_worse_than_the_reference(
        widths, seed):
    """In bf16 the routes round in different places, so both are held to
    the float32 reference's result by the RMS error the plain bf16 route
    itself has there.  The fused encoder computes in float32 (only its
    input and the dense heads round to bf16), so its error is below the
    bf16 reference's (measured 0.4-0.5 of it); the decoder is bf16 on both
    routes and K9 rounds once where the plain chain rounds after the
    LayerNorm and after the LeakyReLU: within 1.5 times (measured
    0.97-1.05).  The control, the reference with fp8 operands, is over 5
    times the bf16 error, so these tolerances fail one precision step
    down."""
    a = WIDTHS[widths]
    f32 = _models(a, "float32", seed)[0]
    ref, port, low = _models(a, "bfloat16", seed)
    u, y = _frames(seed)
    with torch.no_grad():
        fm, _ = f32.encode(u)
        fx = f32.decode(fm, y)
        enc = {k: _rms(m.encode(u)[0] - fm)
               for k, m in (("ref", ref), ("port", port), ("low", low))}
        dec = {k: _rms(m.decode(fm, y) - fx)
               for k, m in (("ref", ref), ("port", port), ("low", low))}
    assert 0 < enc["port"] <= enc["ref"], enc
    assert dec["port"] <= 1.5 * dec["ref"], dec
    assert enc["low"] > 5 * enc["ref"] and dec["low"] > 5 * dec["ref"]


def test_the_configuration_differs_from_the_default_in_its_route_only():
    base = common.load_json("configs", "vawgan-vcc2016")
    fused = copy.deepcopy(CONFIG)
    assert {k: fused["architecture"].pop(k) for k in ROUTES} == ROUTES
    # the default cites the paper, this one the upstream project's
    # architecture file: the same widths
    for k in ("name", "source", "description", "assumed"):
        fused.pop(k), base.pop(k)
    assert fused == base
    port = port_config.Architecture.from_json(CONFIG["architecture"])
    ref = ref_arch.Architecture.from_json(CONFIG["architecture"])
    for a in (port, ref):
        assert (a.conv_impl, a.d2s_impl) == ("pallas", "pallas")
        assert a.encoder.output == (16, 32, 64, 128, 256)
        assert a.generator.output == (128, 64, 32, 16, 1)
    assert port.to_json() == ref.to_json()


def test_the_cell_converts_through_both_fused_wrappers(monkeypatch):
    """The harness's corpus driver on the configuration, at a small
    traffic size on the CPU: every model call of the program (warm-up and
    window, one a request) runs the five encoder layers through
    ``conv_ln_lrelu`` and the three upsampling steps through
    ``d2s_ln_lrelu``, and the window is correct against the plain
    reference."""
    calls = {"conv": 0, "d2s": 0}

    def spy(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    monkeypatch.setattr(vae, "conv_ln_lrelu",
                        spy("conv", vae.conv_ln_lrelu))
    monkeypatch.setattr(vae, "d2s_ln_lrelu", spy("d2s", vae.d2s_ln_lrelu))
    out = run.execute(CELL, 2**31 + 23, 0.5, False, device="cpu",
                      **small.overrides(CELL))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    model_calls = small.CORPUS["warmup_requests"] + out["attempted"]
    assert calls == {"conv": 5 * model_calls, "d2s": 3 * model_calls}
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}


def _wrapper_calls(arch: dict, n: int = 3) -> dict:
    """kernel -> the fused wrappers' positional arguments in one bf16
    encode + decode of ``n`` frames, at ``arch``'s widths."""
    _, port, _ = _models(arch, "bfloat16", seed=0)
    calls = {"conv": [], "d2s": []}
    u, y = _frames(0, n)
    with torch.no_grad(), \
            chip_smoke.spy(vae, "conv_ln_lrelu", calls["conv"]), \
            chip_smoke.spy(vae, "d2s_ln_lrelu", calls["d2s"]):
        z, _ = port.encode(u)
        port.decode(z, y)
    return calls


def test_the_count_is_bound_of_at_the_published_shapes():
    """Each K8 and K9 site of ``roofline/conv_d2s.py`` has the least time
    that ``chip_smoke.py:bound_of`` gives the wrapper's own arguments at
    the published widths, and the same bytes.  Layer 1's products count
    as float32 operations there (its row kernel runs on CUDA cores) where
    bound_of counts them as split TF32; the layer is bound by its bytes
    either way."""
    arch = ref_arch.Architecture.from_json(
        {**CONFIG["architecture"], "compute_dtype": "bfloat16"})
    n = 3
    calls = _wrapper_calls(CONFIG["architecture"], n)
    got = ROOFLINE.sites(arch, n)
    want = ([("conv", c) for c in calls["conv"]]
            + [("d2s", c) for c in calls["d2s"]])
    assert len(got) == len(want) == 8
    for (nbytes, ops, tf32), (name, (args, _)) in zip(got, want):
        ref = chip_smoke.bound_of(name, args, None)
        assert 1e3 * peaks.bound_s(nbytes, ops, tf32) == pytest.approx(
            ref["bound_ms"], rel=1e-9)
        assert 1e3 * nbytes / peaks.HBM_BYTES_PER_S == pytest.approx(
            ref["bytes_ms"], rel=1e-9)
    # the sums over the sites: what one reference call counts
    cfg = ref_convert.World(**CONFIG["world"])
    xs = torch.zeros(2, 4 * cfg.hop)
    model = types.SimpleNamespace(arch=arch)
    total = ROOFLINE.work(model, xs, *[None] * 8, cfg)
    parts = ROOFLINE.sites(arch, 2 * 5)
    assert total == tuple(sum(p[i] for p in parts) for i in range(3))


@pytest.mark.parametrize("route", ["fused", "conv only", "d2s only",
                                   "default"])
def test_the_count_follows_the_route(route):
    impls = {"fused": ROUTES, "conv only": {"conv_impl": "pallas"},
             "d2s only": {"d2s_impl": "pallas"}, "default": {}}[route]
    arch = ref_arch.Architecture.from_json(
        {**common.load_json("configs", "vawgan-vcc2016")["architecture"],
         **impls, "compute_dtype": "bfloat16"})
    n = len(ROOFLINE.sites(arch, 64 * 1201))
    assert n == {"fused": 8, "conv only": 5, "d2s only": 3,
                 "default": 0}[route]
    cfg = ref_convert.World(**CONFIG["world"])
    xs = torch.zeros(64, 6 * cfg.fs)
    b, ops, tf32 = ROOFLINE.work(types.SimpleNamespace(arch=arch), xs,
                                 *[None] * 8, cfg)
    if route == "default":
        # kernels_roofline of the default cell reads what it read before
        assert (b, ops, tf32) == (0, 0, 0)
        assert peaks.bound_s(b, ops, tf32) == 0
    else:
        assert b > 0 and ops > 0 and (tf32 > 0) == (route != "d2s only")


@pytest.mark.parametrize("fused", [True, False])
def test_the_recorder_counts_the_reference_call(fused):
    """The roofline recorder patches the reference's ``convert_rows`` and
    counts one model call of the request's padded frames; on the default
    route nothing, so the share is left out."""
    cfg = copy.deepcopy(common.load_json(
        "configs", "vawgan-vcc2016-fused" if fused else "vawgan-vcc2016"))
    cfg["architecture"] = _narrow(cfg["architecture"])
    arch = ref_arch.Architecture.from_json(
        {**cfg["architecture"], "compute_dtype": "bfloat16"})
    state = _state(arch, 1)
    names = [f"S{i}" for i in range(10)]
    assets = {"speakers": names, "f0_mu": np.full(10, 5.0, np.float32),
              "f0_sigma": np.full(10, 0.1, np.float32),
              "xmin": np.full(513, -10.0, np.float32),
              "xmax": np.full(513, 0.0, np.float32)}
    reference = ref_convert.Reference(arch, state, assets, cfg["world"],
                                      "cpu", bucket_s=0.25)
    rng = np.random.default_rng(0)
    xs = [0.1 * rng.standard_normal(n).astype(np.float32)
          for n in (3000, 3500)]
    rec = kernels.Recorder(["conv_d2s"])
    plain = ref_convert.convert_rows
    with rec.recording():
        assert ref_convert.convert_rows is not plain
        reference.convert_batch(xs, ["S0", "S1"], ["S2", "S3"], [1, 2])
    assert ref_convert.convert_rows is plain
    frames = 2 * (4000 // reference.cfg.hop + 1)
    want = peaks.bound_s(*(sum(p[i] for p in ROOFLINE.sites(arch, frames))
                           for i in range(3)))
    assert rec.bound_s["conv_d2s"] == pytest.approx(want, rel=1e-12)
    assert (want > 0) == fused


def test_the_model_spans_nest_in_vc_model():
    """A profiled conversion on the fused route leaves ``vc.encode`` and
    ``vc.decode`` once per chunk, inside ``vc.model``, encode first."""
    from tpuvc_torch.convert import pipeline
    arch = port_config.Architecture.from_json(
        {**_narrow(CONFIG["architecture"]), "compute_dtype": "float32"})
    state = _state(ref_arch.Architecture.from_json(arch.to_json()), 2)
    model = load_model(arch, state, "cpu")
    assets = pipeline.ConverterAssets(
        xmin=np.full(513, -10.0, np.float32),
        xmax=np.full(513, 0.0, np.float32),
        f0_mu=np.full(10, 5.0, np.float32),
        f0_sigma=np.full(10, 0.1, np.float32),
        speakers=[f"S{i}" for i in range(10)])
    conv = pipeline.Converter(model, assets, bucket_s=0.25, device="cpu")
    rng = np.random.default_rng(1)
    xs = [0.1 * rng.standard_normal(3000).astype(np.float32)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        conv.convert_batch(xs, ["S0"], ["S1"], seed=1)
    spans: dict[str, list] = {}
    for ev in prof.events():
        if ev.name in ("vc.model", "vc.encode", "vc.decode"):
            spans.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    assert {k: len(v) for k, v in spans.items()} == {
        "vc.model": 1, "vc.encode": 1, "vc.decode": 1}
    (ms, me), = spans["vc.model"]
    (es, ee), = spans["vc.encode"]
    (ds, de), = spans["vc.decode"]
    assert ms <= es < ee <= ds < de <= me
