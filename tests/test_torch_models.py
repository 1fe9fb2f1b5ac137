"""The port's VAW-GAN encoder/decoder (tpuvc_torch/models) against the
Flax model, from the same parameters (``from_flax``), on the CPU in
float32 at the repo's full width (``Architecture()``), for the default
architecture and the fused-kernel one (``conv_impl="pallas"``,
``d2s_impl="pallas"``, whose Flax side runs its Pallas kernels in
interpret mode)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuvc.utils.config import Architecture
from tpuvc_torch.models import params as port_params
from tpuvc_torch.models.vae import VAWGAN
from tpuvc_torch.utils import config as port_config


FUSED = dict(conv_impl="pallas", d2s_impl="pallas")


def _flax_and_port(**fields):
    from tpuvc.models.vae import init_params, make_model
    arch = Architecture(**fields)
    model = make_model(arch)
    tree = init_params(model, arch, jax.random.PRNGKey(0))
    # LayerNorm scale/bias of ones/zeros would hide a swapped pair:
    # perturb every leaf so the mapping is checked, not just the shapes
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), tree)
    parch = port_config.Architecture(**fields)
    port = port_params.load_model(parch, port_params.from_flax(tree, parch),
                                  device="cpu")
    return parch, model, tree, port


@pytest.fixture(scope="module")
def flax_model():
    return _flax_and_port()


@pytest.fixture(scope="module")
def flax_fused():
    return _flax_and_port(**FUSED)


@pytest.mark.parametrize("which", ["flax_model", "flax_fused"])
def test_from_flax_covers_the_state_dict(which, request):
    """Every parameter of the Flax encoder and decoder lands in the state
    dict, shapes included; the fused architecture's tree (other names)
    maps onto the same keys."""
    arch, _, tree, port = request.getfixturevalue(which)
    sd = port_params.from_flax(tree, arch)
    ref = VAWGAN(arch).state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        assert v.shape == ref[k].shape, k
    n_flax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        {k: tree["params"][k] for k in ("encoder", "decoder")}))
    assert sum(v.numel() for v in sd.values()) == n_flax


def test_encode_matches_flax(flax_model):
    """float32 both sides: the same convolutions and dense layers summed
    in another order; rtol 1e-4 / atol 1e-4."""
    _, model, tree, port = flax_model
    rng = np.random.default_rng(1)
    u = rng.uniform(-1, 1, (6, 513)).astype(np.float32)
    mu, lv = model.apply(tree, jnp.asarray(u), method=type(model).encode)
    with torch.no_grad():
        pmu, plv = port.encode(torch.from_numpy(u))
    np.testing.assert_allclose(pmu.numpy(), np.asarray(mu), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(plv.numpy(), np.asarray(lv), rtol=1e-4,
                               atol=1e-4)


def test_decode_matches_flax(flax_model):
    """float32, tanh head included: rtol 1e-4 / atol 1e-4."""
    _, model, tree, port = flax_model
    rng = np.random.default_rng(2)
    z = rng.standard_normal((6, 128)).astype(np.float32)
    y = np.array([0, 3, 9, 1, 1, 5], np.int32)
    ref = model.apply(tree, jnp.asarray(z), jnp.asarray(y),
                      method=type(model).decode)
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z), torch.from_numpy(y).long())
    assert got.shape == (6, 513)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_bf16_compute_tracks_float32(flax_model):
    """compute_dtype="bfloat16" (the card's setting) keeps float32
    parameters and outputs; bf16 keeps ~3 significant digits, so the
    tanh-bounded frame stays within 0.1 of the float32 decode."""
    arch, _, tree, port = flax_model
    arch16 = port_config.Architecture(compute_dtype="bfloat16")
    port16 = port_params.load_model(arch16,
                                    port_params.from_flax(tree, arch16),
                                    device="cpu")
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.uniform(-1, 1, (4, 513)).astype(np.float32))
    y = torch.tensor([0, 1, 2, 3])
    with torch.no_grad():
        z32, _ = port.encode(u)
        z16, _ = port16.encode(u)
        d32 = port.decode(z32, y)
        d16 = port16.decode(z32, y)
    assert z16.dtype == d16.dtype == torch.float32
    assert next(port16.parameters()).dtype == torch.float32
    assert torch.allclose(z16, z32, atol=0.1 * z32.abs().max().item())
    assert (d16 - d32).abs().max().item() < 0.1


def test_seeded_init_params():
    """init_params: full width, deterministic in the seed."""
    arch = port_config.Architecture()
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a = port_params.init_params(arch, gen(0), device="cpu")
    b = port_params.init_params(arch, gen(0), device="cpu")
    c = port_params.init_params(arch, gen(1), device="cpu")
    assert set(a) == set(VAWGAN(arch).state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.dense.weight"],
                           c["decoder.dense.weight"])
    model = port_params.load_model(arch, a, device="cpu")
    with torch.no_grad():
        out = model.decode(*model.encode(torch.zeros(2, 513))[:1],
                           torch.tensor([0, 1]))
    assert out.shape == (2, 513) and torch.isfinite(out).all()


@pytest.mark.parametrize("module", ["generator", "critic"])
def test_seeded_init_draws_flax_distributions(module):
    """init_params / init_critic_params at full width draw each tensor from
    Flax's initializer, held against one Flax init_params of the VAW-GAN:
    conv and dense kernels from lecun_normal (truncated at 2 sigma, sigma =
    1/sqrt(fan_in)/0.87962566), so max |w| <= that truncation point; the
    embedding tables from an untruncated normal of std 1/sqrt(128), so
    values beyond 2 sigma occur; biases 0, LayerNorm scales 1.  Each
    tensor's std is within 5% of Flax's where the tensor holds 3600
    elements or more; a smaller tensor's two sample stds differ by
    sampling alone by about 1/sqrt(n) of the std (9.4% at 112), so there
    the bound is three such standard errors."""
    from tpuvc.models.vae import init_params, make_model
    arch = Architecture()
    tree = jax.device_get(init_params(make_model(arch), arch,
                                      jax.random.PRNGKey(0)))
    parch = port_config.Architecture()
    g = torch.Generator().manual_seed(0)
    if module == "generator":
        sd = port_params.init_params(parch, g, device="cpu")
        ref = port_params.from_flax(tree, parch)
    else:
        sd = port_params.init_critic_params(parch, g, device="cpu")
        ref = port_params.critic_from_flax(tree, parch)
    assert set(sd) == set(ref)
    for k, w in sd.items():
        r = ref[k]
        assert w.shape == r.shape, k
        if k.endswith("bias") or "norm" in k:
            assert torch.equal(w, r), k
            continue
        n = w.numel()
        tol = max(0.05, 3.0 / np.sqrt(n))
        assert abs(w.std().item() / r.std().item() - 1.0) <= tol, (
            k, w.std().item(), r.std().item())
        if k.endswith("embed"):
            sigma = 1.0 / np.sqrt(w.shape[1])
            assert (w.abs() > 2 * sigma).any() and (r.abs() > 2 * sigma).any()
        else:
            cut = 2.0 / np.sqrt(w[0].numel()) / 0.87962566103423978
            assert w.abs().max().item() <= cut, k
            assert r.abs().max().item() <= cut * (1 + 1e-6), k


def test_unknown_kernel_switch_is_refused():
    """conv_impl and d2s_impl take "xla" or "pallas", nothing else."""
    with pytest.raises(ValueError, match="conv_impl"):
        VAWGAN(port_config.Architecture(conv_impl="triton"))


def test_architecture_copy_matches_jax(tmp_path):
    """The port's Architecture has the JAX record's fields and defaults,
    and an architecture.json written by either loads the same in both,
    the legacy rules included (no output_activation -> linear head, no
    d_conditional -> unconditioned critic)."""
    import dataclasses
    from tpuvc.utils.config import load_architecture
    assert (dataclasses.asdict(port_config.Architecture())
            == dataclasses.asdict(Architecture()))
    a = Architecture(compute_dtype="bfloat16", y_dim=4)
    a.save(str(tmp_path / "a.json"))
    b = port_config.load_architecture(str(tmp_path / "a.json"))
    assert dataclasses.asdict(b) == dataclasses.asdict(a)
    legacy = {"encoder": {"kernel": [[7, 1]] * 2, "stride": [[3, 1]] * 2,
                          "output": [16, 32]}, "hwc": [513, 1, 1],
              "training": {"lambda": 5.0}}
    assert (dataclasses.asdict(port_config.Architecture.from_json(legacy))
            == dataclasses.asdict(Architecture.from_json(legacy)))


def test_entry_points_default_to_the_card():
    """init_params and load_model run on the CUDA card unless told
    otherwise, and without one they raise instead of falling back."""
    import inspect
    for fn in (port_params.init_params, port_params.load_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    arch = port_config.Architecture()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_params.init_params(arch, torch.Generator().manual_seed(0))
    sd = port_params.init_params(arch, torch.Generator().manual_seed(0),
                                 device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_params.load_model(arch, sd)


def test_fused_encode_decode_matches_flax(flax_fused):
    """The fused-kernel architecture in float32 (K8 per encoder layer, K9
    after the decoder's three stride-3 layers; the Flax side runs the
    Pallas kernels in interpret mode): rtol 1e-4 / atol 1e-4, as the
    default architecture."""
    _, model, tree, port = flax_fused
    rng = np.random.default_rng(4)
    u = rng.uniform(-1, 1, (6, 513)).astype(np.float32)
    y = np.array([0, 3, 9, 1, 1, 5], np.int32)
    mu, lv = model.apply(tree, jnp.asarray(u), method=type(model).encode)
    ref = model.apply(tree, mu, jnp.asarray(y), method=type(model).decode)
    with torch.no_grad():
        pmu, plv = port.encode(torch.from_numpy(u))
        got = port.decode(torch.from_numpy(np.array(mu)),
                          torch.from_numpy(y).long())
    for g, r in ((pmu, mu), (plv, lv), (got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


def test_fused_routes_match_default_routes(flax_fused):
    """The kernel switches pick routes, not parameters: one state dict
    loads into both architectures, and in float32 they agree to rounding
    (rtol 1e-5 / atol 1e-5: the same sums, norms taken in other orders)."""
    arch, _, _, port = flax_fused
    plain = port_params.load_model(port_config.Architecture(),
                                   port.state_dict(), device="cpu")
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.uniform(-1, 1, (5, 513)).astype(np.float32))
    y = torch.tensor([1, 2, 3, 4, 0])
    with torch.no_grad():
        for a, b in zip((*port.encode(u), port.decode(u[:, :128], y)),
                        (*plain.encode(u), plain.decode(u[:, :128], y))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_fused_bf16_matches_flax_bf16(flax_fused):
    """compute_dtype="bfloat16" in both packages, fused architecture: the
    encoder's input is rounded to bfloat16, the fused layers compute in
    float32, the dense heads and the decoder's convs in bfloat16 (K9
    keeps x's type).  bfloat16 keeps ~3 significant digits and the two
    frameworks round at other points, so z within 0.05 of its largest
    magnitude and the tanh-bounded frames within 0.05."""
    from tpuvc.models.vae import make_model
    _, _, tree, _ = flax_fused
    jarch = Architecture(compute_dtype="bfloat16", **FUSED)
    jmodel = make_model(jarch)
    parch = port_config.Architecture(compute_dtype="bfloat16", **FUSED)
    port16 = port_params.load_model(parch, port_params.from_flax(tree, parch),
                                    device="cpu")
    rng = np.random.default_rng(6)
    u = rng.uniform(-1, 1, (4, 513)).astype(np.float32)
    y = np.array([0, 1, 2, 3], np.int32)
    mu, _ = jmodel.apply(tree, jnp.asarray(u), method=type(jmodel).encode)
    ref = jmodel.apply(tree, mu, jnp.asarray(y), method=type(jmodel).decode)
    with torch.no_grad():
        pmu, _ = port16.encode(torch.from_numpy(u))
        got = port16.decode(torch.from_numpy(np.array(mu)),
                            torch.from_numpy(y).long())
    assert pmu.dtype == got.dtype == torch.float32
    mu = np.asarray(mu)
    assert np.abs(pmu.numpy() - mu).max() < 0.05 * np.abs(mu).max()
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 0.05
