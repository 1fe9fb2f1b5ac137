"""Parallel WaveGAN's residual layer, K13 (ops/pwg.py).

On the CPU the wrapper takes its plain version, and these tests hold it
against a straightforward ``F.conv1d`` rendering of the layer in float32
(the dilated convolution with its SAME padding, the conditioning's 1x1,
the gated unit, the skip and out 1x1s, the residual's scale) at every
dilation of the published stacks, at lengths that are not a multiple of
the kernel's 32-position tile, at lengths shorter than the dilation
(every outer tap reads zero) and at one and three rows; the whole
generator built on it against the plain reference
(``benchmark/reference/pwg.py``); and the CPU path's launch counts.  The
``gpu`` tests hold the CUDA kernel against the plain version on the card
at the corpus cell's shape and at ragged ones, and count its launches in a
vocoder call; they skip without a card.

The module imports no JAX, so that the ``gpu`` tests also run on a
machine without it:
``python -m pytest --noconftest tests/test_torch_pwg_layer.py -m gpu``.
"""

import math
import os
import sys
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import vocoder_state  # noqa: E402
from tpuvc_torch.models import pwg  # noqa: E402
from tpuvc_torch.ops import _build  # noqa: E402
from tpuvc_torch.ops import pwg as op  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V1 = pwg.PWGSpec()
# the plain reference's generator at cut widths: 6 layers in 2 stacks
SMALL = {**V1.to_json(), "layers": 6, "stacks": 2, "residual_channels": 8,
         "gate_channels": 16, "skip_channels": 8}
DILATIONS = [2 ** i for i in range(10)]
# (rows, positions, dilation): ragged tiles, T < d, one and three rows
SHAPES = [(2, 1000, d) for d in DILATIONS] + [
    (1, 300, 512), (3, 129, 64), (1, 128, 1), (3, 1, 2), (1, 5, 4)]


def _block(spec: pwg.PWGSpec, dilation: int, dtype=torch.float32,
           device="cpu", seed: int = 1):
    block = pwg._ResidualBlock(spec, dilation)
    state = {k.split(".", 2)[2]: v
             for k, v in vocoder_state(spec, seed).items()
             if k.startswith("conv_layers.0.")}
    block.load_state_dict(state)
    return block.to(device, dtype).eval()


def _inputs(b, t, spec=V1, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, t, spec.residual_channels), generator=g)
    c = torch.randn((b * t, spec.aux_channels), generator=g)
    skip = torch.randn((b * t, spec.skip_channels), generator=g)
    return tuple(v.to(device, dtype) for v in (x, c, skip))


@torch.no_grad()
def _conv1d_layer(block, x, c, skip):
    """The layer as ``torch.nn`` computes it over [B, C, T], in float32:
    the next x and the skip sum with this layer's skip added."""
    b, t, _ = x.shape
    xt = x.transpose(1, 2)
    ct = c.view(b, t, -1).transpose(1, 2)
    h = block.conv(xt) + F.conv1d(ct, block.conv1x1_aux.weight)
    a, g = h.chunk(2, dim=1)
    g = torch.tanh(a) * torch.sigmoid(g)
    s = F.conv1d(g, block.conv1x1_skip.weight)
    x_next = (block.conv1x1_out(g) + xt) * math.sqrt(0.5)
    return (x_next.transpose(1, 2),
            skip + s.transpose(1, 2).reshape(b * t, -1))


@pytest.mark.parametrize("b,t,d", SHAPES)
def test_plain_is_the_conv1d_layer(b, t, d):
    """In float32 the plain version computes the layer: the taps stacked
    on the conditioning make one product of K = 3 x 64 + 80, so the sums
    run in another order (within 1e-5 of the largest value); the
    receptive field's zeros beyond the row's ends are the convolution's
    SAME padding, also where every outer tap lies outside a row shorter
    than the dilation."""
    block = _block(V1, d)
    x, c, skip = _inputs(b, t, seed=d + t)
    want_x, want_skip = _conv1d_layer(block, x, c, skip)
    got_skip = skip.clone()
    got_x = op.residual_layer(x, c, got_skip, block.operands(), d)
    for got, want in ((got_x, want_x), (got_skip, want_skip)):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert torch.allclose(got, want, rtol=0,
                              atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("d", [1, 64])
def test_plain_rounds_three_times_in_bf16(d):
    """In bf16 the plain version rounds g, the skip sum and the next x to
    bf16, once each, and nothing else: the float32 layer from the same
    bf16 operands, rounded there, gives the same bits (the float32 sums
    are the ones the plain version runs)."""
    block = _block(V1, d, torch.bfloat16)
    x, c, skip = _inputs(2, 300, dtype=torch.bfloat16, seed=d)
    ops = block.operands()
    got_skip = skip.clone()
    got_x = op.residual_layer(x, c, got_skip, ops, d)
    f = torch.float32
    xp = F.pad(x.float(), (0, 0, d, d))
    a1 = torch.cat([xp[:, :300], xp[:, d:d + 300], xp[:, 2 * d:2 * d + 300],
                    c.float().view(2, 300, -1)], -1).view(600, -1)
    h = torch.addmm(ops.b_conv, a1, ops.w1.to(f).t())
    g = (torch.tanh(h[:, :64]) * torch.sigmoid(h[:, 64:])).bfloat16().float()
    so = g @ ops.w2.to(f).t()
    want_skip = (skip.float() + so[:, :64]).bfloat16()
    want_x = ((x.float().view(600, -1) + so[:, 64:] + ops.b_out)
              * math.sqrt(0.5)).bfloat16().view(2, 300, -1)
    assert got_x.dtype == got_skip.dtype == torch.bfloat16
    assert torch.equal(got_x, want_x) and torch.equal(got_skip, want_skip)


def test_operands_lay_the_taps_out_by_position():
    """W1's column tap x 64 + channel multiplies x(t + (tap - 1) d), the
    aux rows follow; W2 is the skip 1x1's rows, then the out 1x1's.  The
    block lays them out once, and again after a cast of the module."""
    block = _block(V1, 4)
    ops = block.operands()
    assert ops.w1.shape == (128, 272) and ops.w2.shape == (128, 64)
    assert torch.equal(ops.w1[:, 64:128], block.conv.weight[:, :, 1])
    assert torch.equal(ops.w1[:, 192:], block.conv1x1_aux.weight[:, :, 0])
    assert torch.equal(ops.w2[64:], block.conv1x1_out.weight[:, :, 0])
    assert ops.b_conv.dtype == ops.b_out.dtype == torch.float32
    assert not any(v.requires_grad for v in ops)
    assert block.operands() is ops
    again = block.to(torch.bfloat16).operands()
    assert again.w1.dtype == again.w2.dtype == torch.bfloat16
    assert torch.equal(again.w2, ops.w2.bfloat16())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_generator_matches_the_reference(dtype):
    """The whole generator, every layer through the plain version, at cut
    widths against the plain reference's ``torch.nn`` modules: float32
    within 1e-5 of the output's largest value, bf16 (g, the skip sum and x
    rounded once a layer) more than 30 dB under the output's energy."""
    from benchmark.reference import pwg as ref_pwg
    spec = pwg.PWGSpec.from_json(SMALL)
    state = vocoder_state(spec, seed=3)
    want_model = ref_pwg.make_vocoder(ref_pwg.Spec(SMALL), state, "cpu")
    g = torch.Generator().manual_seed(4)
    c = torch.randn((2, 80, 19), generator=g)
    z = torch.randn((2, 19 * spec.hop), generator=g)
    want = want_model(z, c)
    got = pwg.load_vocoder(spec, state, "cpu", dtype)(z, c)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if dtype == "float32":
        assert torch.allclose(got, want, rtol=0,
                              atol=1e-5 * float(want.abs().max()))
    else:
        db = 10 * torch.log10(((got - want) ** 2).sum() / (want ** 2).sum())
        assert float(db) < -30.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_cpu_counts_no_launch(dtype):
    """On the CPU every layer takes the plain version: no ``"pwg"``
    launch, and the vocoder lists no kernel to require."""
    spec = pwg.PWGSpec(layers=3, stacks=1)
    voc = pwg.load_vocoder(spec, vocoder_state(spec), "cpu", dtype)
    assert pwg.vocoder_kernels(voc) == ()
    n0 = _build.read_counts()["pwg"]
    y = voc(torch.randn((1, 4 * spec.hop)), torch.randn((1, 80, 4)))
    assert torch.isfinite(y).all()
    assert _build.read_counts()["pwg"] == n0


def test_the_wrapper_refuses_what_does_not_fit():
    block = _block(V1, 2)
    x, c, skip = _inputs(2, 50)
    ops = block.operands()
    with pytest.raises(ValueError, match="do not fit"):
        op.residual_layer(x, c[:-1], skip, ops, 2)
    with pytest.raises(ValueError, match="one dtype"):
        op.residual_layer(x.bfloat16(), c, skip, ops, 2)
    with pytest.raises(ValueError, match="dilation"):
        op.residual_layer(x, c, skip, ops, 0)
    with pytest.raises(ValueError, match="out"):
        op.residual_layer(x, c, skip, ops, 2, out=torch.empty(2, 49, 64))
    meta = [v.to("meta") for v in (x, c, skip)]
    with pytest.raises(ValueError, match="no kernel"):
        op.residual_layer(*meta, op.Operands(*(v.to("meta") for v in ops)),
                          2)


def test_only_float32_on_the_card_runs_eager():
    """The block routes by the rows' device and dtype alone: float32 on
    the card runs PyTorch's launches, bf16 on the card (at any widths; the
    wrapper refuses those K13 does not take) goes to K13, and the CPU to
    the plain version; the vocoder lists K13 for a bf16 generator on the
    card only, whatever its widths."""
    cuda = torch.device("cuda")
    for dtype, eager in ((torch.float32, True), (torch.bfloat16, False)):
        assert not pwg.eager_route(torch.zeros(1, dtype=dtype))
        on_card = SimpleNamespace(dtype=dtype, device=cuda)
        assert pwg.eager_route(on_card) == eager
        voc = SimpleNamespace(first_conv=SimpleNamespace(weight=on_card))
        assert pwg.vocoder_kernels(voc) == (() if eager else ("pwg",))
    small = pwg.PWGSpec.from_json(SMALL)
    voc = pwg.load_vocoder(small, vocoder_state(small), "cpu", "bfloat16")
    assert pwg.vocoder_kernels(voc) == ()


# --- the kernel on the card (skips here: no CUDA device) ---------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _bf16_step(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().float().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7.0)


def _kernel_against_plain(b, t, d, dev, seed=0):
    """K13 and the plain version on the card from the same bf16 rows:
    the next x and the skip sum, each held within one bf16 step of the
    plain value plus one bf16 step of every g carried through W2 (K13's
    tanh and its sum order may round a g the other way); most values
    within one step alone."""
    block = _block(V1, d, torch.bfloat16, dev, seed=d)
    x, c, skip = _inputs(b, t, dtype=torch.bfloat16, device=dev, seed=seed)
    ops = block.operands()
    n0 = _build.read_counts()["pwg"]
    got_skip, want_skip = skip.clone(), skip.clone()
    got = op.residual_layer(x, c, got_skip, ops, d)
    assert _build.read_counts()["pwg"] == n0 + 1
    want = op.residual_layer_plain(x, c, want_skip, ops, d)
    w2 = ops.w2.float().abs().sum(1) * 2.0 ** -8     # [skip + res]
    carry = {"skip": w2[:64], "x": w2[64:] * math.sqrt(0.5)}
    for name, g, w in (("x", got.view(b * t, -1), want.view(b * t, -1)),
                       ("skip", got_skip, want_skip)):
        err = (g.float() - w.float()).abs()
        step = _bf16_step(w)
        assert bool(torch.isfinite(g.float()).all()), name
        assert bool((err <= step + carry[name]).all()), (
            name, float(err.max()))
        assert float((err <= step).float().mean()) > 0.99, name
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 512])
def test_kernel_at_the_cells_shape(cuda, d):
    """64 rows of 96,000 samples, a corpus call of the PWG cell, at the
    stacks' first and last dilation."""
    _kernel_against_plain(64, 96000, d, cuda)
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d", SHAPES)
def test_kernel_at_ragged_shapes(cuda, b, t, d):
    _kernel_against_plain(b, t, d, cuda, seed=t)


@pytest.mark.gpu
def test_kernel_writes_its_own_rows_only(cuda):
    """The next x goes into ``out`` and nowhere else: a buffer around it
    keeps its guard values, and x and c are left as they were."""
    block = _block(V1, 8, torch.bfloat16, cuda)
    x, c, skip = _inputs(3, 333, dtype=torch.bfloat16, device=cuda)
    x0, c0 = x.clone(), c.clone()
    buf = torch.full((3 * 333 * 64 + 64,), 7.0, dtype=torch.bfloat16,
                     device=cuda)
    out = buf[:-64].view(3, 333, 64)
    y = op.residual_layer(x, c, skip, block.operands(), 8, out=out)
    assert y.data_ptr() == out.data_ptr()
    assert torch.equal(buf[-64:], torch.full_like(buf[-64:], 7.0))
    assert torch.equal(x, x0) and torch.equal(c, c0)
    with pytest.raises(ValueError, match="overlaps"):
        op.residual_layer(x, c, skip, block.operands(), 8, out=x)
    with pytest.raises(ValueError, match="bfloat16"):
        op.residual_layer(x.float(), c.float(), skip.float(),
                          _block(V1, 8, torch.float32, cuda).operands(), 8)


@pytest.mark.gpu
def test_a_vocoder_call_launches_once_a_layer(cuda):
    """A bf16 generator on the card launches K13 once for each of its 30
    layers and lists it for ``require_launches``; a float32 one launches
    none and keeps cuDNN's and cuBLAS's route; the two waveforms agree
    within bf16's reach (more than 25 dB under the output's energy)."""
    state = vocoder_state(V1, seed=5)
    g = torch.Generator().manual_seed(6)
    c = torch.randn((2, 80, 50), generator=g).to(cuda)
    z = torch.randn((2, 50 * V1.hop), generator=g).to(cuda)
    half = pwg.load_vocoder(V1, state, cuda, "bfloat16")
    full = pwg.load_vocoder(V1, state, cuda, "float32")
    assert pwg.vocoder_kernels(half) == ("pwg",)
    assert pwg.vocoder_kernels(full) == ()
    _build.reset_counts()
    y = half(z, c)
    assert _build.read_counts()["pwg"] == V1.layers
    _build.require_launches(pwg.vocoder_kernels(half), cuda, "vocoder")
    _build.reset_counts()
    want = full(z, c)
    assert _build.read_counts()["pwg"] == 0
    db = 10 * torch.log10(((y - want) ** 2).sum() / (want ** 2).sum())
    assert float(db) < -25.0


def test_chip_smoke_vocoder_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's vocoder phase at a small size on the CPU: the
    wrapper takes its plain version (errors exactly 0), nothing launches,
    the bound is the layer's bytes, and the kernels' record gains K13's
    entry with every key."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn: float("nan"))
    rec = chip_smoke.phase_vocoder(torch.device("cpu"), rows=1, samples=800)
    assert [r["max_abs_err"] for r in rec["sites"]] == [0.0, 0.0]
    assert all(r["within_one_step"] == 1.0 for r in rec["sites"])
    assert all(r["bound_by"] == "bytes" for r in rec["sites"])
    # 672 B a position and the weights: 1.23 ms a layer at 64 x 96000
    bound = chip_smoke.bound_of("pwg", (
        torch.empty((64, 96000, 64), dtype=torch.bfloat16),
        torch.empty((64 * 96000, 80), dtype=torch.bfloat16),
        torch.empty((64 * 96000, 64), dtype=torch.bfloat16),
        _block(V1, 1, torch.bfloat16).operands(), 1), None)
    assert bound["bound_ms"] == pytest.approx(1.2327, abs=1e-3)
    assert rec["launches_per_call"] == rec["float32_launches_per_call"] == 0
    assert rec["wave_err_db_vs_float32"] < -25.0
    entry = chip_smoke.vocoder_record(rec, 0)
    assert entry["name"] == "pwg" and entry["bound_ms"] > 0
    assert entry["launches"] == 0 and entry["launches_path"] == "pwg"
    assert os.path.exists(os.path.join(os.path.dirname(chip_smoke.__file__),
                                       entry["source"]))
