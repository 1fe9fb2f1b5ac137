"""The port's training path (tpuvc_torch.models.losses, the critic,
tpuvc_torch.train, the data stream, the train CLI) against the JAX
package's, on the CPU at tests/test_training.py's small architecture
(z 16, 4 speakers, embedding 8, two- and three-layer stacks, batch 32,
n_unroll 2).  Parameters are made by Flax and carried across with
``from_flax``/``critic_from_flax``; batches come from numpy seeds; the
noise is the JAX key chain's draws, passed through the port's noise
arguments."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from tpuvc.utils.config import Architecture, NetSpec, TrainConfig
from tpuvc_torch.models import losses as port_losses
from tpuvc_torch.models import params as port_params
from tpuvc_torch.models.vae import Critic
from tpuvc_torch.ops._build import KERNEL_NAMES
from tpuvc_torch.train import steps as port_steps
from tpuvc_torch.utils import config as port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = dict(
    z_dim=16, y_dim=4, y_emb_dim=8,
    encoder=NetSpec((7, 7), (3, 3), (8, 16)),
    generator=NetSpec((7, 7, 7), (3, 3, 3), (16, 8, 1)),
    discriminator=NetSpec((7, 7), (3, 3), (8, 16)),
    training=TrainConfig(batch_size=32, lr=1e-3, n_unroll=2, alpha=1.0,
                         gp_lambda=10.0))
B = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the machine: one PyTorch thread
    each (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _archs(**fields):
    """The JAX and the port's Architecture with the same fields."""
    kw = {**SMALL, **fields}
    port_kw = {k: (port_config.NetSpec(*dataclasses.astuple(v))
                   if isinstance(v, NetSpec) else
                   port_config.TrainConfig(**dataclasses.asdict(v))
                   if isinstance(v, TrainConfig) else v)
               for k, v in kw.items()}
    return Architecture(**kw), port_config.Architecture(**port_kw)


def _flax(arch, model_name="VAWGAN", seed=0):
    from tpuvc.models.vae import init_params, make_model
    model = make_model(dataclasses.replace(arch, model=model_name))
    tree = jax.device_get(init_params(model, arch, jax.random.PRNGKey(seed)))
    return model, tree


def _batch(rng, n, y_dim=4):
    """tests/test_training.py's toy frames: a speaker-dependent mean."""
    y = rng.integers(0, y_dim, n)
    base = np.linspace(-1, 1, 513, dtype=np.float32)
    x = (np.sin(base[None, :] * (2 + y[:, None]))
         + 0.05 * rng.standard_normal((n, 513))).astype(np.float32)
    return x, y.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_grads(tree, arch, critic=False):
    """A Flax-shaped tree (parameters or their gradients) in the port's
    names and layouts."""
    return (port_params.critic_from_flax(tree, arch) if critic
            else port_params.from_flax(tree, arch))


def _gan_noise(key, step, n_unroll, z_dim):
    """The JAX VAWGAN step's draws at ``step``: per critic update k the
    reparameterisation from fold_in(r, 2k+1) and the penalty's mix from
    fold_in(r, 2k+2), the generator's from fold_in(r, 0), with r =
    fold_in(key, step)."""
    r = jax.random.fold_in(key, step)
    f = lambda i: jax.random.fold_in(r, i)  # noqa: E731
    return port_steps.VAWGANNoise(
        _t([jax.random.normal(f(2 * k + 1), (B, z_dim))
            for k in range(n_unroll)]),
        _t([jax.random.uniform(f(2 * k + 2), (B, 1))
            for k in range(n_unroll)]),
        _t(jax.random.normal(f(0), (B, z_dim))))


# --- the losses ------------------------------------------------------------

@pytest.fixture(scope="module")
def gan():
    """Flax VAWGAN (small, conditional critic), its params, and the port's
    generator and critic holding them."""
    from tpuvc_torch.models.vae import VAWGAN
    arch, parch = _archs()
    model, tree = _flax(arch)
    gen = VAWGAN(parch)
    gen.load_state_dict(port_params.from_flax(tree, parch))
    critic = Critic(parch)
    critic.load_state_dict(port_params.critic_from_flax(tree, parch))
    return arch, parch, model, tree, gen, critic


@pytest.mark.parametrize("name", ["gaussian_kld", "gaussian_log_density",
                                  "gaussian_log_density_var",
                                  "reparameterize", "wasserstein_distance"])
def test_losses_match_jax(name):
    """Each loss against tpuvc.models.losses on the same inputs: rtol 1e-5
    (float32 sums in another order); reparameterize with the noise the
    JAX function draws from its key."""
    from tpuvc.models import losses
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal((B, 16)).astype(np.float32)
               for _ in range(3))
    key = jax.random.PRNGKey(3)
    if name == "reparameterize":
        ref = losses.reparameterize(key, a, b)
        got = port_losses.reparameterize(
            _t(a), _t(b), _t(jax.random.normal(key, a.shape)))
    elif name == "gaussian_log_density_var":
        ref = losses.gaussian_log_density(a, b, c)
        got = port_losses.gaussian_log_density(_t(a), _t(b), _t(c))
    elif name == "wasserstein_distance":
        ref = losses.wasserstein_distance(a[:, 0], b[:, 0])
        got = port_losses.wasserstein_distance(_t(a[:, 0]), _t(b[:, 0]))
    else:
        ref = getattr(losses, name)(a, b)
        got = getattr(port_losses, name)(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=0)


def test_gradient_penalty_matches_jax(gan):
    """WGAN-GP on the critic carried across from Flax: the JAX side's
    per-sample vmap(grad) and the port's gradient of the summed scores,
    with the JAX function's uniform draw as the mix: rtol 1e-5."""
    from tpuvc.models import losses
    from tpuvc.models.vae import VAWGAN
    _, _, model, tree, _, critic = gan
    rng = np.random.default_rng(2)
    x, y = _batch(rng, B)
    xf = rng.uniform(-1, 1, x.shape).astype(np.float32)
    key = jax.random.PRNGKey(4)

    def single(xi, yi):
        return model.apply(tree, xi[None], yi[None],
                           method=VAWGAN.discriminate)[0]

    ref = losses.gradient_penalty(single, key, x, xf, y)
    got = port_losses.gradient_penalty(
        critic, _t(jax.random.uniform(key, (B, 1))), _t(x), _t(xf),
        _t(y).long())
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)


@pytest.mark.parametrize("case", ["conditional", "conditional_no_y",
                                  "unconditional", "fused"])
def test_critic_matches_flax(case):
    """The critic's score against VAWGAN.discriminate from the same params
    (float32): with the projection term, without y, with d_conditional
    False, and with conv_impl="pallas" (the Flax side's Pallas layers in
    interpret mode, the port's plain versions): rtol 1e-4 / atol 1e-4, as
    the encoder's test."""
    from tpuvc.models.vae import VAWGAN
    fields = {"unconditional": {"d_conditional": False},
              "fused": {"conv_impl": "pallas"}}.get(case, {})
    arch, parch = _archs(**fields)
    model, tree = _flax(arch, seed=1)
    rng = np.random.default_rng(3)
    # perturb every leaf: unit norms and zero biases would hide a swap
    tree = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        tree)
    critic = Critic(parch)
    critic.load_state_dict(port_params.critic_from_flax(tree, parch))
    x, y = _batch(rng, 6)
    with_y = case != "conditional_no_y"
    ref = model.apply(tree, x, y if with_y else None,
                      method=VAWGAN.discriminate)
    with torch.no_grad():
        got = critic(_t(x), _t(y).long() if with_y else None)
    assert got.shape == (6,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


# --- gradients and steps ---------------------------------------------------

def _jax_losses(model, arch):
    """The JAX VAWGAN step's two objectives (tpuvc/train/steps.py
    critic_loss, gen_loss) as functions of the critic's and the
    generator's subtrees."""
    from tpuvc.models import losses
    from tpuvc.models.vae import VAWGAN
    from tpuvc.train.state import merge_gan_params
    t = arch.training

    def critic_loss(crit, gen, x, y, r1, r2):
        params = merge_gan_params(gen, crit)
        out = model.apply(params, x, y, r1)
        xh = jax.lax.stop_gradient(out["xh"])
        d_fake = model.apply(params, xh, y, method=VAWGAN.discriminate)
        w = losses.wasserstein_distance(out["d_real"], d_fake)

        def single(xi, yi):
            return model.apply(params, xi[None], yi[None],
                               method=VAWGAN.discriminate)[0]

        gp = losses.gradient_penalty(single, r2, x, xh, y)
        return -w + t.gp_lambda * gp

    def gen_loss(gen, crit, x, y, r):
        out = model.apply(merge_gan_params(gen, crit), x, y, r)
        kld = losses.gaussian_kld(out["z_mu"], out["z_lv"])
        logp = losses.gaussian_log_density(x, out["xh"])
        return kld - logp + t.alpha * -jnp.mean(out["d_fake"])

    return jax.jit(jax.grad(critic_loss)), jax.jit(jax.grad(gen_loss))


@pytest.mark.parametrize("which", ["critic", "generator"])
def test_loss_gradients_match_jax(gan, which):
    """At the same params, batch and noise (the key chain's draws for
    step 0, critic update 0 and the generator update), the port's
    gradient of each objective w.r.t. its own module against jax.grad's,
    per tensor: max |g - g_jax| <= 1e-4 x max |g_jax| (float32 sums in
    another order; the critic's through the penalty's second-order
    terms)."""
    from tpuvc.train.state import split_gan_params
    arch, parch, model, tree, gen, critic = gan
    rng = np.random.default_rng(5)
    x, y = _batch(rng, B)
    key = jax.random.PRNGKey(7)
    r = jax.random.fold_in(key, 0)
    noise = _gan_noise(key, 0, 1, arch.z_dim)
    gen_tree, crit_tree = split_gan_params(tree)
    d_grad, g_grad = _jax_losses(model, arch)
    tx, ty = _t(x), _t(y).long()
    if which == "critic":
        ref = d_grad(crit_tree, gen_tree, x, y, jax.random.fold_in(r, 1),
                     jax.random.fold_in(r, 2))
        ref = _port_grads(jax.device_get(ref), parch, critic=True)
        loss, _ = port_steps.critic_loss(gen, critic, tx, ty,
                                         noise.z_crit[0], noise.gp[0],
                                         arch.training.gp_lambda)
        module = critic
    else:
        ref = g_grad(gen_tree, crit_tree, x, y, jax.random.fold_in(r, 0))
        ref = _port_grads({"params": jax.device_get(ref)}, parch)
        loss, _ = port_steps.generator_loss(gen, critic, tx, ty,
                                            noise.z_gen,
                                            arch.training.alpha)
        module = gen
    names = [n for n, _ in module.named_parameters()]
    got = torch.autograd.grad(loss, list(module.parameters()))
    assert set(names) == set(ref)
    for n, g in zip(names, got):
        scale = ref[n].abs().max().item()
        err = (g - ref[n]).abs().max().item()
        assert err <= 1e-4 * scale, (n, err, scale)


# the parameter rule (chip_smoke.py:params_agree): Adam's first update is
# about lr sign(g), so an element whose gradient is near 0 turns on rounding
# and may move 2 lr the other way on either side.  Elements whose |g| in
# every update of the run is at least SIGNIFICANT of its tensor's max |g|
# agree within TOL lr + 1e-6 |p|; every other element within 2 lr for each
# update it took.
SIGNIFICANT, TOL = 1e-3, 1e-3


def _assert_params_close(got, ref, opt_grads, module, lr):
    chip_smoke.params_agree(got, ref,
                            chip_smoke.named_grads(module, opt_grads), lr,
                            SIGNIFICANT, TOL)


def test_two_vawgan_steps_match_jax(gan):
    """Two consecutive VAW-GAN steps (2 critic updates and a generator
    update each) from the same init, batches and key chain: the loss dict
    within rtol 1e-4 after each step, and the generator's and critic's
    parameters under the parameter rule (_assert_params_close)."""
    from tpuvc.train import steps as steps_lib
    from tpuvc.train.state import split_gan_params
    from tpuvc.models.vae import VAWGAN as JaxVAWGAN
    arch, parch, _, tree, _, _ = gan
    model = JaxVAWGAN(arch=arch)
    tx_g, tx_d = steps_lib.make_gan_optimizers(arch)
    gen_tree, crit_tree = split_gan_params(tree)
    jstate = steps_lib.VAWGANTrainState(
        params=tree, opt_g=tx_g.init(gen_tree), opt_d=tx_d.init(crit_tree),
        step=jnp.zeros((), jnp.int32))
    jstep = steps_lib.make_vawgan_step(model, arch)
    state = port_steps.vawgan_state(
        parch, port_params.from_flax(tree, parch),
        port_params.critic_from_flax(tree, parch), "cpu")
    seen_g = chip_smoke.record_grads(state.opt_g)
    seen_d = chip_smoke.record_grads(state.opt_d)
    rng = np.random.default_rng(6)
    key = jax.random.PRNGKey(7)
    n = arch.training.n_unroll
    for s in range(2):
        xs, ys = zip(*(_batch(rng, B) for _ in range(n + 1)))
        xc, yc = np.stack(xs[:-1]), np.stack(ys[:-1])
        jstate, jm = jstep(jstate, xc, yc, xs[-1], ys[-1], key)
        m = port_steps.vawgan_step(state, _t(xc), _t(yc).long(),
                                   _t(xs[-1]), _t(ys[-1]).long(),
                                   _gan_noise(key, s, n, arch.z_dim))
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
        p = jax.device_get(jstate.params)
        lr = arch.training.lr
        _assert_params_close(dict(state.gen.named_parameters()),
                             port_params.from_flax(p, parch), seen_g,
                             state.gen, lr)
        _assert_params_close(dict(state.critic.named_parameters()),
                             port_params.critic_from_flax(p, parch), seen_d,
                             state.critic, lr)
    assert state.step == int(jstate.step) == 2


def test_two_vae_steps_match_jax():
    """Two VAE steps from the same CVAE init, batches and key chain
    (eps from fold_in(key, step)): {D_KL, logP, loss} within rtol 1e-4,
    parameters under the parameter rule."""
    from tpuvc.models.vae import CVAE
    from tpuvc.train import steps as steps_lib
    arch, parch = _archs(model="VAE", trainer="VAETrainer")
    model = CVAE(arch=arch)
    jstate = steps_lib.init_vae_state(model, arch, jax.random.PRNGKey(0))
    jstep = steps_lib.make_vae_step(model, arch)
    tree = jax.device_get(jstate.params)
    state = port_steps.vae_state(parch, port_params.from_flax(tree, parch),
                                 "cpu")
    seen = chip_smoke.record_grads(state.opt)
    rng = np.random.default_rng(8)
    key = jax.random.PRNGKey(9)
    for s in range(2):
        x, y = _batch(rng, B)
        jstate, jm = jstep(jstate, x, y, key)
        eps = _t(jax.random.normal(jax.random.fold_in(key, s),
                                   (B, arch.z_dim)))
        m = port_steps.vae_step(state, _t(x), _t(y).long(), eps)
        for k in ("D_KL", "logP", "loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
        _assert_params_close(
            dict(state.model.named_parameters()),
            port_params.from_flax(jax.device_get(jstate.params), parch),
            seen, state.model, arch.training.lr)


def test_vawgan_updates_are_isolated():
    """The critic updates leave the generator untouched and the generator
    update leaves the critic untouched (bit for bit), no critic gradient
    is left over from the generator loss, and both modules move in a
    step; tests/test_training.py's
    test_vawgan_critic_update_leaves_generator_untouched on the port."""
    _, parch = _archs()
    state = port_steps.init_vawgan_state(parch, 0, "cpu")
    snap = lambda m: {n: p.detach().clone()  # noqa: E731
                      for n, p in m.named_parameters()}
    gen0, crit0 = snap(state.gen), snap(state.critic)
    at_gen_update = {}

    def before_gen_update(opt, *_):
        at_gen_update["gen"] = snap(state.gen)
        at_gen_update["critic"] = snap(state.critic)
        at_gen_update["critic_grads"] = [p.grad for p in
                                         state.critic.parameters()]

    state.opt_g.register_step_pre_hook(before_gen_update)
    rng = np.random.default_rng(10)
    n = parch.training.n_unroll
    xs, ys = zip(*(_batch(rng, B) for _ in range(n + 1)))
    g = port_steps.step_generator(0, 0, torch.device("cpu"))
    port_steps.vawgan_step(state, _t(np.stack(xs[:-1])),
                           _t(np.stack(ys[:-1])).long(), _t(xs[-1]),
                           _t(ys[-1]).long(),
                           port_steps.vawgan_noise(g, B, parch))
    assert all(torch.equal(at_gen_update["gen"][k], gen0[k]) for k in gen0)
    assert any(not torch.equal(at_gen_update["critic"][k], crit0[k])
               for k in crit0)
    assert all(v is None for v in at_gen_update["critic_grads"])
    crit1 = snap(state.critic)
    assert all(torch.equal(crit1[k], at_gen_update["critic"][k])
               for k in crit1)
    assert any(not torch.equal(p, gen0[k])
               for k, p in snap(state.gen).items())


@pytest.mark.parametrize("field", ["conv_impl", "d2s_impl"])
def test_training_refuses_the_kernel_routes(field, tmp_path):
    """The fused-kernel routes have no gradient in the JAX package: the
    training state and the trainers refuse them with a ValueError that
    says so, instead of training another route."""
    from tpuvc_torch.train.trainer import VAETrainer, VAWGANTrainer
    _, parch = _archs(**{field: "pallas"})
    with pytest.raises(ValueError, match="no VJP"):
        port_steps.init_vawgan_state(parch, 0, "cpu")
    with pytest.raises(ValueError, match="no VJP"):
        port_steps.init_vae_state(parch, 0, "cpu")
    for cls in (VAETrainer, VAWGANTrainer):
        with pytest.raises(ValueError, match=field):
            cls(parch, str(tmp_path / cls.__name__), device="cpu",
                use_tensorboard=False)


# --- data ------------------------------------------------------------------

def _toy_dataset(rng, n=200):
    from tpuvc_torch.data.dataset import FrameDataset
    x, y = _batch(rng, n)
    return FrameDataset(x=x, y=y)


@pytest.mark.parametrize("skip", [0, 7])
def test_batch_stream_matches_jax(skip):
    """BatchStream (Tanhize-normalised, drop_remainder), after ``skip``
    batches, over 3 epochs of a 200-frame table in batches of 32: every
    batch bit-equal to the JAX package's for the same seed."""
    from tpuvc.data.dataset import FrameDataset as JaxDataset
    from tpuvc.data.normalizer import Tanhize as JaxTanhize
    ds = _toy_dataset(np.random.default_rng(11))
    jds = JaxDataset(x=ds.x, y=ds.y)
    a = ds.batches(B, seed=3, normalizer=ds.fit_normalizer())
    b = jds.batches(B, seed=3, normalizer=JaxTanhize.fit(ds.x))
    a.skip(skip)
    b.skip(skip)
    for _ in range(18):
        (xa, ya), (xb, yb) = next(a), next(b)
        assert xa.dtype == xb.dtype and np.array_equal(xa, xb)
        assert np.array_equal(ya, yb)


@pytest.mark.parametrize("mmap", [False, True])
def test_frame_dataset_from_bin_dir_matches_jax(mmap, tmp_path):
    """FrameDataset.from_bin_dir over .bin records of 2 speakers reads the
    same sp frames and labels as the JAX package's (bit-equal, in the same
    file order), and refuses a record file that is not a whole number of
    RECORD_DIM floats."""
    from tpuvc.data.dataset import FrameDataset as JaxDataset
    from tpuvc_torch.data.dataset import FrameDataset
    from tpuvc_torch.io import corpus, records
    rng = np.random.default_rng(14)
    for spk in range(2):
        for u, n in enumerate((7, 12)):
            d = os.path.join(tmp_path, "bin", corpus.TRAIN_SPLIT, f"S{spk}")
            os.makedirs(d, exist_ok=True)
            records.write_bin(os.path.join(d, f"u{u}.bin"), records.Features(
                sp=rng.standard_normal((n, 513)).astype(np.float32),
                ap=rng.uniform(0, 1, (n, 513)).astype(np.float32),
                f0=rng.uniform(0, 300, n).astype(np.float32),
                en=rng.uniform(0, 9, n).astype(np.float32), label=spk))
    ds = FrameDataset.from_bin_dir(str(tmp_path), mmap=mmap)
    ref = JaxDataset.from_bin_dir(str(tmp_path), mmap=mmap)
    assert len(ds) == 38 and ds.x.dtype == np.float32
    assert np.array_equal(ds.x, ref.x) and np.array_equal(ds.y, ref.y)
    with open(os.path.join(d, "u1.bin"), "ab") as f:
        f.write(np.zeros(3, np.float32).tobytes())
    with pytest.raises(ValueError, match="RECORD_DIM"):
        FrameDataset.from_bin_dir(str(tmp_path), mmap=mmap)


@pytest.mark.parametrize("style", ["vowel", "hard"])
def test_make_corpus_bytes_match_jax(style, tmp_path):
    """make_corpus writes byte-identical WAVs (and speaker table) to the
    JAX package's for the same seed; the hard style in its parallel mode,
    whose draws come from two generators."""
    import filecmp
    from tpuvc.data import synthetic as jax_synth
    from tpuvc_torch.data import synthetic
    kw = dict(n_train=2, n_test=1, dur_s=0.3, seed=4, style=style,
              parallel=style == "hard")
    synthetic.make_corpus(str(tmp_path / "port"), **kw)
    jax_synth.make_corpus(str(tmp_path / "jax"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                   for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    assert len(files) == 4 * 3 + 1
    for f in files:
        assert filecmp.cmp(tmp_path / "port" / f, tmp_path / "jax" / f,
                           shallow=False), f


@pytest.mark.parametrize("log_input", [True, False])
def test_image_and_logdir_copies_match_jax(log_input, tmp_path):
    """The port's copies of tpuvc/utils/image.py and logdir.py: the same
    spectrogram thumbnails, byte for byte, and the same run-directory
    rules (a restore_from directory is reused, a new one gets msg.txt)."""
    from tpuvc.utils import image as jax_image
    from tpuvc.utils import logdir as jax_logdir
    from tpuvc_torch.utils import image, logdir
    rng = np.random.default_rng(13)
    frames = rng.uniform(1e-6, 1.0, (40, 513)).astype(np.float32)
    a = image.spectrogram_image(frames, log_input=log_input)
    b = jax_image.spectrogram_image(frames, log_input=log_input)
    assert a.dtype == np.uint8 and a.shape == (513, 40, 3)
    assert np.array_equal(a, b)
    run = logdir.make_run_dir(str(tmp_path / "logs"), msg="note")
    with open(os.path.join(run, "msg.txt")) as f:
        assert f.read() == "note\n"
    assert os.path.dirname(run) == str(tmp_path / "logs" / "train")
    for make in (logdir.make_run_dir, jax_logdir.make_run_dir):
        assert make("unused", restore_from=run) == run
        with pytest.raises(FileNotFoundError):
            make("unused", restore_from=str(tmp_path / "missing"))


def test_metrics_writer_flush_matches_jax(tmp_path):
    """MetricsWriter.flush, as the JAX writer's: without TensorBoard it
    does nothing (metrics.jsonl is written through on every record), and
    with a writer it flushes that writer once per call."""
    from tpuvc.train.summaries import MetricsWriter as JaxWriter
    from tpuvc_torch.train.summaries import MetricsWriter

    class Board:
        def __init__(self):
            self.flushes = 0

        def flush(self):
            self.flushes += 1

    boards = []
    for kind, make in (("port", MetricsWriter), ("jax", JaxWriter)):
        w = make(str(tmp_path / kind), use_tensorboard=False)
        w.scalars(3, {"loss": 0.5})
        w.flush()
        with open(tmp_path / kind / "metrics.jsonl") as f:
            rec = json.loads(f.read())
        assert rec["step"] == 3 and rec["loss"] == 0.5
        w._tb = Board()
        w.flush()
        w.flush()
        boards.append(w._tb.flushes)
        w._tb = None
        w.close()
    assert boards == [2, 2]


# --- checkpoints and trainers ----------------------------------------------

def _params(state):
    return {**{f"gen.{n}": p for n, p in state.gen.state_dict().items()},
            **{f"critic.{n}": p for n, p in state.critic.state_dict().items()}}


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """A VAW-GAN run of 6 steps, then a new trainer on the same run
    directory resuming to 8, ends bit-equal to a straight run of 8 steps
    (parameters, both optimizers' states, the last metrics): the resume
    restores the checkpoint, skips 6 x (n_unroll + 1) batches of the
    stream and draws each step's noise from (seed, step).  Only the 5
    newest checkpoints stay, and no temporary file is left."""
    from tpuvc_torch.train.trainer import VAWGANTrainer
    _, parch = _archs()
    ds = _toy_dataset(np.random.default_rng(12))

    def run(name, stops):
        run_dir = str(tmp_path / name)
        for total in stops:
            t = VAWGANTrainer(parch, run_dir, seed=5, use_tensorboard=False,
                              device="cpu")
            m = t.train(ds.batches(B, seed=5), total_steps=total,
                        log_every=1, save_every=1)
            t.close()
        return t, m

    a, ma = run("straight", [8])
    b, mb = run("resumed", [6, 8])
    assert a.state.step == b.state.step == 8 and ma == mb
    pa, pb = _params(a.state), _params(b.state)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    for oa, ob in ((a.state.opt_g, b.state.opt_g),
                   (a.state.opt_d, b.state.opt_d)):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa
                   for k in sa[i])
    ckpts = sorted(os.listdir(tmp_path / "resumed" / "ckpt"))
    assert ckpts == [f"{s}.pt" for s in (4, 5, 6, 7, 8)]
    with open(tmp_path / "resumed" / "events" / "metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == list(range(1, 9))


def test_resident_trainer_contract(tmp_path):
    """tests/test_training.py's test_resident_multistep_trains_and_resumes
    on the port: n_inner steps per call land on the step count, a run
    resumes from its checkpoint, a complete run does nothing and returns
    {}, a remainder call lands exactly on total_steps, a repeat call keeps
    the uploaded table, an in-place edit of the table uploads it anew, and
    the VAE learns on this path."""
    from tpuvc_torch.train.trainer import VAETrainer, VAWGANTrainer
    _, parch = _archs()
    rng = np.random.default_rng(7)
    data, labels = _batch(rng, 512)
    kw = dict(use_tensorboard=False, device="cpu")
    run = str(tmp_path / "resident")
    t1 = VAWGANTrainer(parch, run, **kw)
    m1 = t1.train_resident(data, labels, total_steps=10, n_inner=5,
                           log_every=5, save_every=10)
    assert t1.state.step == 10 and all(np.isfinite(v) for v in m1.values())
    assert set(m1) == {"W_dist", "GP", "l_D", "D_KL", "logP", "l_G", "adv"}
    t1.close()
    t2 = VAWGANTrainer(parch, run, **kw)
    t2.train_resident(data, labels, total_steps=20, n_inner=5)
    assert t2.state.step == 20
    t2.close()
    t3 = VAWGANTrainer(parch, run, **kw)
    assert t3.train_resident(data, labels, total_steps=20, n_inner=5) == {}
    assert t3.state.step == 20
    t3.train_resident(data, labels, total_steps=23, n_inner=5)
    assert t3.state.step == 23
    assert t3.ckpt.latest_step == 23
    dev_table = t3._resident_dev
    t3.train_resident(data, labels, total_steps=33, n_inner=5)
    assert t3.state.step == 33 and t3._resident_dev is dev_table
    data *= 1.5
    t3.train_resident(data, labels, total_steps=38, n_inner=5)
    assert t3._resident_dev is not dev_table
    data /= 1.5
    t3.close()
    tv = VAETrainer(parch, str(tmp_path / "resident_vae"), **kw)
    early = tv.train_resident(data, labels, total_steps=5, n_inner=5,
                              log_every=1, save_every=1000)
    late = tv.train_resident(data, labels, total_steps=60, n_inner=5,
                             log_every=1, save_every=1000)
    assert late["loss"] < early["loss"]
    tv.close()


def test_trainers_default_to_the_card(tmp_path):
    """The trainers, the training state and cli.train default to the CUDA
    card and raise without one instead of falling back to the CPU."""
    import inspect
    from tpuvc_torch.cli import train as cli_train
    from tpuvc_torch.train.trainer import _BaseTrainer
    assert (inspect.signature(_BaseTrainer).parameters["device"].default
            == "cuda")
    for fn in (port_steps.init_vawgan_state, port_steps.vawgan_state,
               port_steps.init_vae_state, port_steps.vae_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    _, parch = _archs()
    from tpuvc_torch.train.trainer import make_trainer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_trainer(parch, str(tmp_path / "run"), use_tensorboard=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(["--corpus", str(tmp_path)])
    with pytest.raises(KeyError, match="unknown trainer"):
        make_trainer(dataclasses.replace(parch, trainer="GAN"),
                     str(tmp_path / "run"), device="cpu")


def test_phase6_rehearses_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 6 (train) end to end on the CPU at a small
    size: a 2-speaker synthetic corpus analysed by cli.analyze, cli.train
    streaming then resumed on the resident path (the small architecture's
    file, 2 then 4 steps), the card-vs-CPU step run CPU against CPU, and
    the VAE's loss falling over its resident run.  The CLI's run directory
    holds architecture.json, metrics.jsonl and the checkpoints.  Phase 7
    (convert) then runs on that run directory and corpus: all pairs, a
    decim-2 Harvest pair, a streamed pair, load_converter twice and both
    evaluate modes, every counter read 0 (the CPU takes the plain
    versions).  Phase 8 (parallel) then runs on 2 x cpu at a small size:
    sharded serving on both paths, 2 streams, a 1 s frame-sharded
    analysis, a 2-rank gloo step of the small architecture against one
    process, a one-rank gloo world and cli.convert --data_parallel
    against phase 7's files."""
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    _, parch = _archs()
    arch_path = str(tmp_path / "small.json")
    parch.save(arch_path)
    cpu = torch.device("cpu")
    rec = chip_smoke.phase_train(
        cpu, str(tmp_path), arch_path=arch_path, n_speakers=2, n_utts=2,
        n_test=2, dur_s=0.5, steps=2, resident=2, vae_steps=40,
        step_batch=B)
    assert rec["resumed_at"] == 2 and rec["final_step"] == 4
    assert rec["analyze_launches"] == dict.fromkeys(KERNEL_NAMES, 0)
    assert rec["train_launches"] == dict.fromkeys(KERNEL_NAMES, 0)
    assert rec["ckpts"] == ["2.pt", "4.pt"]
    assert rec["logged_steps"] == [2, 4]
    assert rec["card_vs_cpu"]["max_rel_err"] == 0.0
    assert rec["step_nhwc_convs"] == 0
    assert rec["vae"]["last"] < rec["vae"]["first"]
    assert all(v[tag] > 0 for k, v in rec["times"].items()
               if k.endswith("_ms") for tag in ("tf32_on", "tf32_off"))

    conv = chip_smoke.phase_convert(cpu, rec["run_dir"], rec["corpus"],
                                    str(tmp_path / "converted"))
    calls = ("all_pairs", "harvest_decim2", "streaming",
             "evaluate_round_trip", "evaluate_conversion")
    assert all(conv[c]["launches"] == dict.fromkeys(KERNEL_NAMES, 0)
               for c in calls)
    assert conv["all_pairs"]["files"] == 2 * 2 * 1
    assert conv["card_vs_cpu_snr_db"] >= 300.0      # CPU against CPU
    assert conv["evaluate_round_trip"]["result"]["mean"] < 8.0
    assert conv["evaluate_conversion"]["result"]["n_utterances"] == 2

    par = chip_smoke.phase_parallel(
        cpu, chip_smoke.build_state(), rec["corpus"], rec["run_dir"],
        str(tmp_path / "converted" / "all_pairs"), str(tmp_path), batch=4,
        dur_s=0.5, fused_batch=2, n_streams=2, stream_s=1.6, long_s=1.0,
        arch_path=arch_path, step_batch=B, timed_steps=1)
    assert par["mesh"] == ["cpu", "cpu"]
    for path in ("default", "fused"):
        assert par[path]["dp_vs_one_snr_db"] >= 40.0
        assert par[path]["launches_dp"] == dict.fromkeys(
            KERNEL_NAMES, 0)
    assert par["analyze_sharded"]["rel_err"]["sp"] < 1e-3
    assert par["train_2rank"]["devices"] == ["cpu", "cpu"]
    assert par["train_2rank"]["max_rel_err"] < 1e-5
    assert par["one_rank"] == {"backend": "gloo", "device": "cpu",
                               "ok": True}
    assert par["cli_data_parallel"]["files"] == 2 * 2 * 1
