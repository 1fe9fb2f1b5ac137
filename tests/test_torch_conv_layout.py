"""The model's convolutions on their two routes (tpuvc_torch/models/vae.py,
``Conv``): the serving route, one channels-last ``F.conv2d`` over the
activations where they lie, against the transposing ``F.conv1d`` route
that training keeps, and the rule that picks between them.

The CPU tests take every serving site of the published architecture
(``configs/architecture-vawgan-vcc2016.json``) and an asymmetric SAME
pad; the ``gpu`` tests hold each site in bfloat16 on the card, a whole
model call, and a profile of one call that must launch no layout
conversion: ``python -m pytest --noconftest
tests/test_torch_conv_layout.py -m gpu``.  The module imports no JAX.
"""

import os

import pytest
import torch

from tpuvc_torch.models import params, vae
from tpuvc_torch.ops.conv import same_pad
from tpuvc_torch.utils.config import Architecture, NetSpec

ARCH_PATH = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                         "architecture-vawgan-vcc2016.json")
FUSED = dict(conv_impl="pallas", d2s_impl="pallas")
SMALL = dict(z_dim=16, y_dim=4, y_emb_dim=8,
             encoder=NetSpec((7, 7), (3, 3), (8, 16)),
             generator=NetSpec((7, 7, 7), (3, 3, 3), (16, 8, 1)),
             discriminator=NetSpec((7, 7), (3, 3), (8, 16)))
# the layout conversions the serving route must not launch on the card
CONVERSIONS = ("transposeBlock", "nchwToNhwc", "nhwcToNchw")


def _sites():
    """(name, L, Cin, Cout, k, stride, depth-to-space factor) of the ten
    serving convolutions: the encoder's five, then the decoder's five
    (each stride-1, Cout = c * s)."""
    arch = Architecture.load(ARCH_PATH)
    out, length, cin = [], arch.x_dim, 1
    enc = arch.encoder
    for i, (k, s, c) in enumerate(zip(enc.kernel, enc.stride, enc.output)):
        out.append((f"enc{i + 1}", length, cin, c, k, s, 1))
        length, cin = -(-length // s), c
    gen = arch.generator
    length, cin = vae.Decoder.base_len, gen.output[0]
    for i, (k, s, c) in enumerate(zip(gen.kernel, gen.stride, gen.output)):
        out.append((f"dec{i + 1}", length, cin, c * s, k, 1, s))
        length, cin = length * s, c
    return out


SITES = _sites()
DECODER = [s for s in SITES if s[0].startswith("dec")]
# L 8, k 7, stride 3: SAME pads (2, 3)
ASYMMETRIC = ("asym", 8, 4, 5, 7, 3, 1)


@pytest.fixture
def routes(monkeypatch):
    """A reader of the convolutions served on each route since the test
    began: (channels-last, transposing); every ``Conv.forward`` call that
    does not go through ``Conv._nhwc`` transposes."""
    n = dict.fromkeys(("forward", "_nhwc"), 0)
    for name in n:
        def counted(self, h, _real=getattr(vae.Conv, name), _name=name):
            n[_name] += 1
            return _real(self, h)
        monkeypatch.setattr(vae.Conv, name, counted)
    return lambda: (n["_nhwc"], n["forward"] - n["_nhwc"])


def _conv(site, device="cpu", seed=0):
    """The site's ``Conv`` (eval mode) with seeded weights and bias, and a
    contiguous input [3, L, Cin]."""
    _, length, cin, cout, k, s, _ = site
    g = torch.Generator().manual_seed(seed)
    conv = vae.Conv(cin, cout, k, s)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g)
                          / (cin * k) ** 0.5)
        conv.bias.copy_(torch.randn(cout, generator=g))
    h = torch.randn((3, length, cin), generator=g)
    return conv.to(device).eval(), h.to(device)


def _both_routes(conv, h):
    """(serving route, transposing route) of one convolution: eval mode
    under no_grad, then train mode."""
    with torch.no_grad():
        nhwc = conv(h)
        conv.train()
        ncl = conv(h)
        conv.eval()
    return nhwc, ncl


def _step_bf16(m):
    """The bfloat16 step at magnitudes ``m`` (float32 math)."""
    _, e = torch.frexp(m.float())
    return torch.exp2((e - 8).clamp_min(-133).float())


# --- the CPU -----------------------------------------------------------

def test_sites_are_the_published_ones():
    assert [s[1:] for s in SITES] == [
        (513, 1, 16, 7, 3, 1), (171, 16, 32, 7, 3, 1), (57, 32, 64, 7, 3, 1),
        (19, 64, 128, 7, 3, 1), (7, 128, 256, 7, 3, 1),
        (19, 128, 384, 7, 1, 3), (57, 128, 192, 7, 1, 3),
        (171, 64, 96, 7, 1, 3), (513, 32, 16, 7, 1, 1),
        (513, 16, 1, 7, 1, 1)]
    # every SAME pad of the published architecture is symmetric
    pads = [same_pad(s[1], s[4], s[5]) for s in SITES]
    assert all(lo == hi for lo, hi in pads)
    assert same_pad(*ASYMMETRIC[1:2], *ASYMMETRIC[4:6]) == (2, 3)


@pytest.mark.parametrize("site", SITES + [ASYMMETRIC], ids=lambda s: s[0])
def test_nhwc_route_matches_conv1d_route(routes, site):
    """float32: the channels-last convolution against the transposing
    F.conv1d route within 1e-5 of the output's largest magnitude, same
    shape; one convolution counted on each route."""
    conv, h = _conv(site)
    nhwc, ncl = _both_routes(conv, h)
    length, cout, s = site[1], site[3], site[5]
    assert nhwc.shape == ncl.shape == (3, -(-length // s), cout)
    scale = ncl.abs().max().item()
    assert (nhwc - ncl).abs().max().item() <= 1e-5 * scale
    assert routes() == (1, 1)


@pytest.mark.parametrize("site", DECODER, ids=lambda s: s[0])
def test_decoder_output_is_contiguous_rows(site):
    """At the decoder's sites the output is a contiguous [B, Lout, Cout],
    so the depth-to-space reshape after it is a view, not a copy."""
    conv, h = _conv(site)
    with torch.no_grad():
        y = conv(h)
    assert y.is_contiguous() and y.shape == (3, site[1], site[3])
    s = site[6]
    d2s = y.reshape(3, site[1] * s, -1)
    assert d2s.data_ptr() == y.data_ptr() and d2s._base is not None


@pytest.mark.parametrize("case,route", [
    ("eval_no_grad", "nhwc"), ("train_no_grad", "ncl"),
    ("eval_param_grad", "ncl"), ("eval_input_grad", "ncl"),
    ("eval_frozen_params", "nhwc")])
def test_the_rule(routes, case, route):
    """The serving route where the module is in eval mode and autograd
    needs no graph through the call; the transposing route in train mode
    or where a parameter or the input needs a gradient (whose backward
    then runs through F.conv1d)."""
    conv, h = _conv(SITES[1])
    if case == "train_no_grad":
        conv.train()
    if case == "eval_frozen_params":
        conv.requires_grad_(False)
    if case == "eval_input_grad":
        h.requires_grad_()
    with torch.set_grad_enabled(case not in ("eval_no_grad",
                                             "train_no_grad")):
        y = conv(h)
    assert routes() == ((1, 0) if route == "nhwc" else (0, 1))
    if y.requires_grad:
        y.square().sum().backward()
        assert conv.weight.grad is not None or h.grad is not None


def _model(**fields):
    arch = Architecture(**fields)
    state = params.init_params(arch, torch.Generator().manual_seed(0),
                               device="cpu")
    return params.load_model(arch, state, device="cpu")


@pytest.mark.parametrize("route,counts", [("default", (5, 5)),
                                          ("fused", (0, 5)),
                                          ("small", (2, 3))])
def test_counters_per_serving_call(routes, route, counts):
    """One encode + decode of a model in eval mode (as ``load_model``
    gives it) under no_grad serves every convolution outside K8 on the
    channels-last route: 10 on the default route, 5 on the fused one (the
    encoder's five are K8), none on the transposing route."""
    model = _model(**{"default": {}, "fused": FUSED, "small": SMALL}[route])
    g = torch.Generator().manual_seed(1)
    x = torch.rand((3, model.arch.x_dim), generator=g)
    with torch.no_grad():
        z, _ = model.encode(x)
        assert routes() == (counts[0], 0)
        xh = model.decode(z, torch.arange(3) % model.arch.y_dim)
    assert routes() == (sum(counts), 0)
    assert xh.shape == (3, model.arch.x_dim)


@pytest.mark.parametrize("route", ["default", "fused", "small"])
def test_model_matches_conv1d_route(routes, route):
    """A whole encode + decode in float32 on the CPU: the serving call
    (no_grad: every convolution channels-last) against the same model
    with grad enabled (every convolution transposing), within 1e-5 of the
    largest magnitude (K8 runs the fused route's encoder on both sides)."""
    model = _model(**{"default": {}, "fused": FUSED, "small": SMALL}[route])
    g = torch.Generator().manual_seed(1)
    x = torch.rand((3, model.arch.x_dim), generator=g) * 2 - 1
    z = torch.randn((3, model.arch.z_dim), generator=g)
    y = torch.arange(3) % model.arch.y_dim
    with torch.no_grad():
        mu, _ = model.encode(x)
        xh = model.decode(z, y)
    served = routes()
    ref_mu, _ = model.encode(x)
    ref_xh = model.decode(z, y)
    assert served[1] == 0 and routes() == (served[0], served[0])
    for got, ref in ((mu, ref_mu), (xh, ref_xh)):
        scale = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 1e-5 * scale


def test_counters_in_a_training_step(routes):
    """A VAW-GAN step (its critic updates, their no-grad generator passes,
    the generator update) keeps the transposing route throughout."""
    from tpuvc_torch.train import steps
    arch = Architecture(**SMALL)
    state = steps.init_vawgan_state(arch, 0, "cpu")
    n, b = arch.training.n_unroll, 4
    g = torch.Generator().manual_seed(2)
    xc = torch.rand((n, b, arch.x_dim), generator=g) * 2 - 1
    yc = torch.randint(0, arch.y_dim, (n, b), generator=g)
    steps.vawgan_step(state, xc, yc, xc[0], yc[0],
                      steps.vawgan_noise(steps.step_generator(
                          0, 0, torch.device("cpu")), b, arch))
    nhwc, ncl = routes()
    assert nhwc == 0 and ncl > 0


# --- the card (skip here: no CUDA device) ------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: cuDNN's channels-last "
                    "convolutions run on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 45, 64 * 1201])
@pytest.mark.parametrize("site", SITES + [ASYMMETRIC], ids=lambda s: s[0])
def test_site_in_bf16_on_card(cuda, site, b):
    """bfloat16 at a frame, a live tick's 45 and a corpus call's 76,864:
    the channels-last route within one bfloat16 step of the transposing
    route in the convolution, carried through the bias add that both
    routes run after it: a step at the larger of the outputs and the
    convolution before its bias (where the bias cancels it), plus the
    add's own rounding, a step of the output (ties round to even, so
    convolutions one step apart can give sums two steps apart).  The
    output is contiguous."""
    conv, _ = _conv(site, cuda)
    g = torch.Generator(device=cuda).manual_seed(b)
    h = torch.randn((b, site[1], site[2]), generator=g,
                    device=cuda).to(torch.bfloat16)
    nhwc, ncl = _both_routes(conv, h)
    assert nhwc.is_contiguous() and nhwc.dtype == torch.bfloat16
    out = torch.maximum(nhwc.float().abs(), ncl.float().abs())
    pre = (ncl.float() - conv.bias.to(torch.bfloat16).float()).abs()
    bound = _step_bf16(torch.maximum(out, pre)) + _step_bf16(out)
    assert ((nhwc.float() - ncl.float()).abs() <= bound).all()


@pytest.mark.gpu
@pytest.mark.parametrize("route,n", [("default", 10), ("fused", 5),
                                     ("small", 5)])
def test_model_on_card_matches_the_conv1d_route(cuda, routes, route, n):
    """A whole encode and decode in bfloat16: the serving routes (no_grad)
    against the same module with grad enabled (the transposing
    convolutions, ATen's LayerNorm), within tests/test_torch_models.py's
    bfloat16 tolerance (z within 0.05 of its largest magnitude, the
    tanh-bounded frames within 0.05)."""
    fields = {"default": {}, "fused": FUSED, "small": SMALL}[route]
    arch = Architecture(compute_dtype="bfloat16", **fields)
    state = params.init_params(arch, torch.Generator().manual_seed(0),
                               device="cpu")
    model = params.load_model(arch, state, device=cuda)
    g = torch.Generator().manual_seed(1)
    x = (torch.rand((4096, arch.x_dim), generator=g) * 2 - 1).to(cuda)
    z = torch.randn((4096, arch.z_dim), generator=g).to(cuda)
    y = (torch.arange(4096) % arch.y_dim).to(cuda)
    with torch.no_grad():
        mu, _ = model.encode(x)
        xh = model.decode(z, y)
    assert routes() == (n, 0)
    ref_mu, _ = model.encode(x)
    ref_xh = model.decode(z, y)
    assert routes() == (n, n)
    assert (mu - ref_mu).abs().max() <= 0.05 * ref_mu.abs().max()
    assert (xh - ref_xh).abs().max() <= 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["default", "fused"])
def test_serving_call_launches_no_layout_conversion(cuda, route):
    """A profile of one serving encode + decode (bfloat16, a corpus call's
    76,864 frames): cuDNN's convolutions and K11 launch, and no kernel
    named after a layout conversion does."""
    from torch.profiler import ProfilerActivity, profile
    arch = Architecture(compute_dtype="bfloat16",
                        **(FUSED if route == "fused" else {}))
    state = params.init_params(arch, torch.Generator().manual_seed(0),
                               device="cpu")
    model = params.load_model(arch, state, device=cuda)
    x = torch.rand((64 * 1201, arch.x_dim), device=cuda)
    y = torch.arange(64 * 1201, device=cuda) % arch.y_dim

    def call():
        with torch.no_grad():
            model.decode(model.encode(x)[0], y)
    call()                                  # cuDNN picks its algorithms
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("norm_lrelu" in n for n in names), sorted(names)
    assert any("conv" in n.lower() or "xmma" in n for n in names)
    bad = sorted(n for n in names if any(c in n for c in CONVERSIONS))
    assert not bad, bad
