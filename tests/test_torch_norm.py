"""K11, the model's LayerNorm + LeakyReLU (tpuvc_torch/ops/norm.py), and
the rule by which ``models/vae.py:LayerNorm.lrelu`` takes it.

On the CPU the model keeps its two PyTorch calls, so its outputs are
today's bit for bit, and the plain version stands in for the kernel where
a test moves the rule off the card.  The ``gpu`` tests hold the kernel
against the plain version at every site shape of the architecture and a
whole model call against the ATen path:
``python -m pytest --noconftest tests/test_torch_norm.py -m gpu``.
The module imports no JAX.
"""

import pytest
import torch
import torch.nn.functional as F

from tpuvc_torch.models import params
from tpuvc_torch.ops import _build, norm
from tpuvc_torch.ops.conv import LN_EPS, conv_ln_lrelu
from tpuvc_torch.ops.d2s import d2s_ln_lrelu
from tpuvc_torch.utils.config import Architecture, NetSpec

FUSED = dict(conv_impl="pallas", d2s_impl="pallas")
# widths of no site of the published architecture: 8 and 16 channels, a
# 304-wide dense_norm (19 x 16)
SMALL = dict(z_dim=16, y_dim=4, y_emb_dim=8,
             encoder=NetSpec((7, 7), (3, 3), (8, 16)),
             generator=NetSpec((7, 7, 7), (3, 3, 3), (16, 8, 1)),
             discriminator=NetSpec((7, 7), (3, 3), (8, 16)))
ROUTES = {"default": {}, "fused": FUSED, "small": SMALL}
SLOPE = 0.2
# (L, C) of every LayerNorm the default route runs outside the dense_norm:
# the encoder's five layers, then the decoder's four steps
SITES = [(171, 16), (57, 32), (19, 64), (7, 128), (3, 256),
         (57, 128), (171, 64), (513, 32), (513, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _today(h, w, b):
    """The model's two calls before K11, in h's dtype."""
    return F.leaky_relu(F.layer_norm(h, h.shape[-1:], w.to(h.dtype),
                                     b.to(h.dtype), LN_EPS), SLOPE)


def _today_stack(stack, h):
    for conv, ln in zip(stack.convs, stack.norms):
        if stack.fused:
            h = conv_ln_lrelu(h, conv.weight.permute(2, 1, 0), conv.bias,
                              ln.weight, ln.bias, conv.stride, stack.slope)
        else:
            h = _today(conv(h), ln.weight, ln.bias)
    return h


def _today_encode(model, x):
    enc, dtype = model.encoder, model.dtype
    h = _today_stack(enc.stack, x[..., None].to(dtype))
    h = h.reshape(h.shape[0], -1).to(dtype)
    return enc.mu(h).float(), enc.log_var(h).float()


def _today_decode(model, z, y):
    dec, dtype = model.decoder, model.dtype
    h = torch.cat([z.to(dtype), dec.embed.to(dtype)[y]], dim=-1)
    h = _today(dec.dense(h), dec.dense_norm.weight, dec.dense_norm.bias)
    h = h.reshape(h.shape[0], dec.base_len, -1)
    last = len(dec.convs) - 1
    for i, (conv, s) in enumerate(zip(dec.convs, dec.strides)):
        h = conv(h)
        if s > 1 and i < last and dec.fused_d2s:
            ln = dec.norms[i]
            h = d2s_ln_lrelu(h.contiguous(), ln.weight, ln.bias, s,
                             dec.slope)
            continue
        if s > 1:
            h = h.reshape(h.shape[0], h.shape[1] * s, -1)
        if i < last:
            h = _today(h, dec.norms[i].weight, dec.norms[i].bias)
    out = h.squeeze(-1)
    return (torch.tanh(out) if dec.tanh else out).float()


def _model(dtype="bfloat16", device="cpu", **fields):
    """The full-width model with every parameter moved off its seeded
    value (LayerNorm's ones and zeros would hide gamma's rounding)."""
    arch = Architecture(compute_dtype=dtype, **fields)
    g = torch.Generator().manual_seed(0)
    state = params.init_params(arch, g, device="cpu")
    state = {k: v + 0.05 * torch.randn(v.shape, generator=g)
             for k, v in state.items()}
    return params.load_model(arch, state, device=device)


def _inputs(model, n, device="cpu"):
    arch = model.arch
    g = torch.Generator().manual_seed(1)
    x = torch.rand((n, arch.x_dim), generator=g) * 2 - 1
    z = torch.randn((n, arch.z_dim), generator=g)
    y = torch.arange(n) % arch.y_dim
    return x.to(device), z.to(device), y.to(device)


def _ulps_bf16(a, b, floor=0.0):
    """|a - b| in bfloat16 steps at the larger magnitude, a step being at
    least ``floor`` (float32 math)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    step = torch.exp2((e - 8).clamp_min(-133).float()).clamp_min(floor)
    return (a - b).abs() / step


def _rows(b, length, c, layout, dtype, device="cpu", seed=0):
    """x [b, length, c] contiguous ("rows") or as the transpose of a
    contiguous [b, c, length] ("slab": a strided view, which the wrapper
    makes contiguous first), with per-channel offsets; gamma and beta
    float32 [c]."""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device)
    shape = (b, length, c) if layout == "rows" else (b, c, length)
    x = 2 * torch.randn(shape, **kw) + 0.5
    x = (x if layout == "rows" else x.transpose(1, 2)).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, **kw)
    beta = 0.1 * torch.randn(c, **kw)
    return x, gamma, beta


# --- the CPU: the model unchanged, the plain version, the rule ---------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("route", ["default", "fused"])
def test_model_on_cpu_is_todays_bit_for_bit(route, dtype):
    """On the CPU every LayerNorm keeps F.layer_norm + F.leaky_relu: the
    encoder's and decoder's outputs equal the composition before K11."""
    model = _model(dtype, **ROUTES[route])
    x, z, y = _inputs(model, 3)
    with torch.no_grad():
        mu, lv = model.encode(x)
        xh = model.decode(z, y)
        ref_mu, ref_lv = _today_encode(model, x)
        ref_xh = _today_decode(model, z, y)
    assert torch.equal(mu, ref_mu) and torch.equal(lv, ref_lv)
    assert torch.equal(xh, ref_xh)
    assert _build.read_counts()["norm"] == 0


@pytest.mark.parametrize("site,layout", [
    *[(s, lay) for s in SITES for lay in ("rows", "slab")],
    ((1, 2432), "rows")], ids=lambda v: v if isinstance(v, str)
    else f"{v[0]}x{v[1]}")
def test_plain_matches_todays_two_calls(site, layout):
    """The plain version (float32 statistics, one rounding) against the
    model's two calls in h's dtype at every site width (the dense_norm's
    2432 as a dense layer's rows): within one bfloat16 step in bfloat16,
    equal in float32."""
    length, c = site
    for dtype in (torch.bfloat16, torch.float32):
        x, gamma, beta = _rows(5, length, c, layout, dtype, seed=c)
        if c == 2432:
            x = x[:, 0]
        got = norm.norm_lrelu_plain(x, gamma, beta, SLOPE)
        ref = _today(x, gamma, beta)
        assert got.dtype == dtype and got.is_contiguous()
        assert got.shape == x.shape
        if dtype == torch.bfloat16:
            assert _ulps_bf16(got, ref).max().item() <= 1.0
        else:
            assert torch.equal(got, ref)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    x, gamma, beta = _rows(4, 57, 32, "slab", torch.bfloat16)
    got = norm.norm_lrelu(x, gamma, beta, SLOPE)
    assert torch.equal(got, norm.norm_lrelu_plain(x, gamma, beta, SLOPE))
    assert _build.read_counts()["norm"] == 0


@pytest.mark.parametrize("case", ["float64", "one_axis", "gamma_shape"])
def test_wrapper_refuses_wrong_inputs(case):
    x, gamma, beta = _rows(2, 7, 16, "rows", torch.float32)
    with pytest.raises(ValueError):
        if case == "float64":
            norm.norm_lrelu(x.double(), gamma, beta, SLOPE)
        elif case == "one_axis":
            norm.norm_lrelu(x[0, 0], gamma, beta, SLOPE)
        else:
            norm.norm_lrelu(x, gamma[:8], beta, SLOPE)


def test_needs_graph():
    w = torch.ones(16, requires_grad=True)
    h = torch.zeros(2, 16)
    assert norm.needs_graph(h, w)
    assert not norm.needs_graph(h, w.detach())
    assert norm.needs_graph(h.requires_grad_(), w.detach())
    with torch.no_grad():
        assert not norm.needs_graph(h, w)
    # on the CPU the rule never engages, whatever autograd needs
    with torch.no_grad():
        assert not norm.engages(torch.zeros(2, 16), w)


def _rule_off_the_card(monkeypatch):
    """K11's rule without its device test, and a count of the wrapper's
    calls: on the CPU the wrapper then runs the plain version."""
    calls = []
    real = norm.norm_lrelu
    monkeypatch.setattr(norm, "engages",
                        lambda h, *p: not norm.needs_graph(h, *p))
    monkeypatch.setattr(norm, "norm_lrelu", lambda *a: (calls.append(1),
                                                        real(*a))[1])
    return calls


@pytest.mark.parametrize("route,sites", [("default", (5, 5)),
                                         ("fused", (0, 2)),
                                         ("small", (2, 3))])
def test_model_takes_the_kernel_only_without_a_graph(monkeypatch, route,
                                                     sites):
    """With the rule off the card: under no_grad every LayerNorm outside
    K8 and K9 goes through the wrapper (default route: the encoder's 5,
    the dense_norm and 4 decoder steps; fused: the dense_norm and the
    stride-1 step; an architecture of other widths: each of its sites, the
    rule asking nothing of the width), within bfloat16 rounding of today's
    outputs; with grad enabled and parameters that require grad none
    does, and the outputs and gradients are today's exactly."""
    model = _model("bfloat16", **ROUTES[route])
    x, z, y = _inputs(model, 3)
    calls = _rule_off_the_card(monkeypatch)
    with torch.no_grad():
        mu, _ = model.encode(x)
        assert len(calls) == sites[0]
        xh = model.decode(z, y)
        assert len(calls) == sum(sites)
        ref_mu, _ = _today_encode(model, x)
        ref_xh = _today_decode(model, z, y)
    assert (mu - ref_mu).abs().max() <= 0.05 * ref_mu.abs().max()
    assert (xh - ref_xh).abs().max() <= 0.05

    calls.clear()
    out = model.encode(x)[0].square().sum() + model.decode(z, y).sum()
    assert not calls
    grads = torch.autograd.grad(out, list(model.parameters()),
                                allow_unused=True)
    ref_out = (_today_encode(model, x)[0].square().sum()
               + _today_decode(model, z, y).sum())
    ref_grads = torch.autograd.grad(ref_out, list(model.parameters()),
                                    allow_unused=True)
    assert torch.equal(out, ref_out)
    for a, b in zip(grads, ref_grads):
        assert (a is None and b is None) or torch.equal(a, b)


def test_training_keeps_the_two_calls(monkeypatch):
    """A model in train mode never calls the wrapper, even under no_grad
    with the rule off the card: training's no-grad generator passes (the
    critic updates') keep the arithmetic of its backward-capable ones, and
    the trainer's generator and critic are in train mode."""
    from tpuvc_torch.train import steps
    st = steps.init_vawgan_state(Architecture(), 0, "cpu")
    assert st.gen.training and st.critic.training
    model = _model("float32").train()
    x, z, y = _inputs(model, 3)
    calls = _rule_off_the_card(monkeypatch)
    with torch.no_grad():
        mu, _ = model.encode(x)
        xh = model.decode(z, y)
        score = st.critic(x, y)
        assert torch.equal(mu, _today_encode(model, x)[0])
        assert torch.equal(xh, _today_decode(model, z, y))
    assert not calls and score.shape == (3,)


def test_counter_is_registered():
    assert "norm" in _build.KERNEL_NAMES
    assert "norm" in _build.read_counts()
    assert "tpuvc_norm_lrelu" in _build.SIGNATURES


# --- the card (skip here: no CUDA device) ------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check_on_card(x, gamma, beta, dtype):
    """Both sides compute in float32 and round once, but their statistics
    sum in other orders: each output within one bfloat16 step, or, where
    (x - mean) * rstd * gamma and beta cancel to a value near zero, within
    the 1e-5 that float32 keeps of the terms (a corpus call's 200 M values
    hold such cancellations; the float32 comparison's atol)."""
    ref = norm.norm_lrelu_plain(x, gamma, beta, SLOPE)
    n0 = _build.read_counts()["norm"]
    got = norm.norm_lrelu(x, gamma, beta, SLOPE)
    assert _build.read_counts()["norm"] == n0 + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert got.is_contiguous()
    if dtype == torch.bfloat16:
        assert _ulps_bf16(got, ref, floor=1e-5).max().item() <= 1.0
    else:
        err = (got - ref).abs() - 1e-5 * ref.abs()
        assert err.max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 45, 64 * 1201])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("site", SITES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_matches_plain_on_card(cuda, site, dtype, b):
    """Every site shape of the architecture, contiguous rows as the model
    gives them, at one frame, a live tick's 45 and a corpus call's
    76,864: bfloat16 within one step, float32 within 1e-5 (sums in
    another order)."""
    dt = getattr(torch, dtype)
    x, gamma, beta = _rows(b, *site, "rows", dt, device=cuda, seed=site[1])
    _check_on_card(x, gamma, beta, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 45, 64 * 1201])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_norm_kernel_matches_plain_on_card(cuda, dtype, b):
    dt = getattr(torch, dtype)
    x, gamma, beta = _rows(b, 1, 2432, "rows", dt, device=cuda)
    _check_on_card(x[:, 0], gamma, beta, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [8, 24, 48, 304, 1000])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layout", ["rows", "slab"])
def test_other_widths_match_plain_on_card(cuda, c, dtype, layout):
    """Widths of no site of the published architecture take the kernel's
    run-time width (a transposed input copied to rows first)."""
    dt = getattr(torch, dtype)
    x, gamma, beta = _rows(45, 7, c, layout, dt, device=cuda, seed=c)
    assert norm.engages(x, gamma, beta)
    _check_on_card(x, gamma, beta, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("route,sites", [("default", (5, 5)),
                                         ("fused", (0, 2)),
                                         ("small", (2, 3))])
def test_model_on_card_matches_the_aten_path(cuda, route, sites):
    """A whole encode and decode in bfloat16: K11 (no_grad) against the
    ATen path the same module takes with grad enabled, within
    tests/test_torch_models.py's bfloat16 tolerance (z within 0.05 of its
    largest magnitude, the tanh-bounded frames within 0.05); one launch
    per site."""
    model = _model("bfloat16", device=cuda, **ROUTES[route])
    x, z, y = _inputs(model, 4096, cuda)
    n0 = _build.read_counts()["norm"]
    with torch.no_grad():
        mu, _ = model.encode(x)
        assert _build.read_counts()["norm"] == n0 + sites[0]
        xh = model.decode(z, y)
        assert _build.read_counts()["norm"] == n0 + sum(sites)
    ref_mu, _ = model.encode(x)
    ref_xh = model.decode(z, y)
    assert _build.read_counts()["norm"] == n0 + sum(sites)
    assert (mu - ref_mu).abs().max() <= 0.05 * ref_mu.abs().max()
    assert (xh - ref_xh).abs().max() <= 0.05
