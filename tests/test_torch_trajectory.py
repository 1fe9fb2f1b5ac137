"""Many steps of the port's VAW-GAN trainer in lockstep with the JAX one.

``tests/test_torch_train.py`` holds two VAW-GAN steps against JAX's; a
fault that compounds over hundreds of steps (Adam's state across the
critic updates, the gradient penalty's double backward) would pass it.
Here both packages start from one Flax init (the port's through
``from_flax`` / ``critic_from_flax``), take the same minibatches, drawn
with numpy from one fixed frame table in the Tanhize range, and the same
noise, JAX's key chain (``tpuvc.train.steps.make_vawgan_step`` draws it
inside; the port is handed it), for ``N_STEPS`` steps on the CPU, with
the critic conditioned and not.

A GAN parts two float32 trajectories fast: Adam's early updates are about
lr sign(g), so an element whose gradient sits at rounding level turns, and
the critic and generator amplify what turned.  How fast is measured on
JAX alone, from the same batches and noise:

- ``ulp``: from the init moved one ulp (``np.nextafter`` towards +inf)
  in every parameter;
- ``kick``: from the same init, every parameter moved one ulp in a
  random direction after every step, which is what differs between two
  float32 implementations that sum in other orders at every step (the
  port's convolutions and reductions do).

At every snapshot the port's relative distance to JAX,
||theta_port - theta_jax|| / ||theta_jax - theta_0|| for each of the
encoder, decoder and critic, stays within MULTIPLE times the furthest
either baseline gets from JAX over the run, or under FLOOR where both stay
at rounding level.  The run's furthest, not the same snapshot's: the
parting starts with a discrete event (an Adam element turning) whose step
varies from run to run, so in the first snapshots a ratio taken step by
step is unbounded (at step 25 of one seed the port stood 1896 times
further from JAX than either baseline, both still at rounding level),
while the level all three settle at is not.  Each entry
of the last step's loss dict lies within MULTIPLE times the largest gap
either baseline shows on that entry over the last snapshot's steps.
Measured (PERF.md, §6), 125 steps, init and data seeds 0-9, both
critics: the port's distance at most 2.21x the baselines' furthest, its
last losses at most 2.01x their gap; at full width 1.14x.  A port whose
critic's Adam restarted at every update fails it with both critics (9.7x
and 14x); one with Adam's eps at 1e-6 for 1e-8 stays inside the float32
spread here and fails ``test_adam_matches_optax_over_many_updates`` (and
the two-step test).  Two parts of the card's training path that the
lockstep does not run are held here too: Adam's foreach implementation,
and the resident path's row and noise draws.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuvc.utils.config import Architecture, NetSpec, TrainConfig
from tpuvc_torch.models import params as port_params
from tpuvc_torch.train import steps as port_steps
from tpuvc_torch.utils import config as port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_training.py's narrow architecture (as tests/test_torch_train.py)
SMALL = dict(
    z_dim=16, y_dim=4, y_emb_dim=8,
    encoder=NetSpec((7, 7), (3, 3), (8, 16)),
    generator=NetSpec((7, 7, 7), (3, 3, 3), (16, 8, 1)),
    discriminator=NetSpec((7, 7), (3, 3), (8, 16)),
    training=TrainConfig(batch_size=32, lr=1e-3, n_unroll=2, alpha=1.0,
                         gp_lambda=10.0))
N_STEPS, EVERY = 125, 25
FRAMES_PER_SPEAKER = 300
MULTIPLE, FLOOR = 4.0, 1e-3
MODULES = ("encoder", "decoder", "critic")
ADAM_UPDATES, ULPS, BEYOND_LR = 500, 2, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the machine: one PyTorch thread
    each (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_arch(arch: Architecture) -> port_config.Architecture:
    """The port's Architecture with the JAX one's fields."""
    kw = {f.name: getattr(arch, f.name) for f in dataclasses.fields(arch)}
    for net in ("encoder", "generator", "discriminator"):
        kw[net] = port_config.NetSpec(*dataclasses.astuple(kw[net]))
    kw["training"] = port_config.TrainConfig(
        **dataclasses.asdict(kw["training"]))
    return port_config.Architecture(**kw)


def frame_table(arch: Architecture, seed: int = 0):
    """FRAMES_PER_SPEAKER toy frames per speaker in the Tanhize range:
    a speaker-dependent sinusoid over the bins plus noise, clipped to
    [-1, 1]."""
    rng = np.random.default_rng(seed)
    y = np.repeat(np.arange(arch.y_dim), FRAMES_PER_SPEAKER)
    base = np.linspace(-1, 1, arch.x_dim, dtype=np.float32)
    x = (0.8 * np.sin(base[None, :] * (2 + y[:, None]))
         + 0.1 * rng.standard_normal((len(y), arch.x_dim)))
    return np.clip(x, -1, 1).astype(np.float32), y.astype(np.int32)


def module_vectors(gen_sd: dict, critic_sd: dict) -> dict:
    """Each module's parameters as one float64 vector, in name order."""
    named = {**gen_sd, **{"critic." + k: v for k, v in critic_sd.items()}}
    return {m: np.concatenate([np.asarray(named[k], np.float64).ravel()
                               for k in sorted(named) if k.startswith(m)])
            for m in MODULES}


def lockstep(arch: Architecture, n_steps: int, every: int,
             seed: int = 0) -> dict:
    """Run the port and three JAX runs (``jax``, ``ulp``, ``kick``) in
    lockstep; returns the relative distances to ``jax`` at every
    ``every``-th step and the loss dicts of the last ``every`` steps."""
    from tpuvc.models.vae import VAWGAN, init_params, make_model
    from tpuvc.train import steps as steps_lib
    from tpuvc.train.state import split_gan_params
    parch = port_arch(arch)
    t = arch.training
    b, n = t.batch_size, t.n_unroll
    tree = jax.device_get(init_params(make_model(arch), arch,
                                      jax.random.PRNGKey(seed)))
    tx_g, tx_d = steps_lib.make_gan_optimizers(arch)

    def jax_state(params):
        gen, critic = split_gan_params(params)
        return steps_lib.VAWGANTrainState(
            params=params, opt_g=tx_g.init(gen), opt_d=tx_d.init(critic),
            step=jnp.zeros((), jnp.int32))

    def vectors(params):
        params = jax.device_get(params)
        return module_vectors(port_params.from_flax(params, parch),
                              port_params.critic_from_flax(params, parch))

    @jax.jit
    def kick(params, k):
        leaves, tdef = jax.tree.flatten(params)
        keys = jax.random.split(k, len(leaves))
        return jax.tree.unflatten(tdef, [
            jnp.nextafter(a, jnp.where(jax.random.bernoulli(kk, 0.5, a.shape),
                                       jnp.inf, -jnp.inf).astype(a.dtype))
            for a, kk in zip(leaves, keys)])

    key = jax.random.PRNGKey(7)

    @jax.jit
    def noise(step):
        # the draws make_vawgan_step takes at ``step`` (tests/
        # test_torch_train.py:_gan_noise)
        r = jax.random.fold_in(key, step)
        f = lambda i: jax.random.fold_in(r, i)  # noqa: E731
        return (jnp.stack([jax.random.normal(f(2 * k + 1), (b, arch.z_dim))
                           for k in range(n)]),
                jnp.stack([jax.random.uniform(f(2 * k + 2), (b, 1))
                           for k in range(n)]),
                jax.random.normal(f(0), (b, arch.z_dim)))

    jstep = steps_lib.make_vawgan_step(VAWGAN(arch=arch), arch)
    runs = {"jax": jax_state(tree),
            "ulp": jax_state(jax.tree.map(
                lambda a: np.nextafter(a, np.float32(np.inf)), tree)),
            "kick": jax_state(tree)}
    state = port_steps.vawgan_state(
        parch, port_params.from_flax(tree, parch),
        port_params.critic_from_flax(tree, parch), "cpu")
    theta0 = vectors(tree)
    x_tab, y_tab = frame_table(arch, seed)
    rng = np.random.default_rng(seed + 1)
    kick_key = jax.random.PRNGKey(seed + 11)
    snaps, losses = [], []
    for s in range(n_steps):
        idx = rng.integers(0, len(x_tab), (n + 1, b))
        batch = (x_tab[idx[:n]], y_tab[idx[:n]], x_tab[idx[n]],
                 y_tab[idx[n]])
        metrics = {}
        for name in runs:
            runs[name], m = jstep(runs[name], *batch, key)
            metrics[name] = m
        runs["kick"] = runs["kick"].replace(params=kick(
            runs["kick"].params, jax.random.fold_in(kick_key, s)))
        zc, gp, zg = (torch.from_numpy(np.array(a)) for a in noise(s))
        xc, yc, xg, yg = (torch.from_numpy(a) for a in batch)
        metrics["port"] = port_steps.vawgan_step(
            state, xc, yc.long(), xg, yg.long(),
            port_steps.VAWGANNoise(zc, gp, zg))
        if s >= n_steps - every:
            losses.append({name: {k: float(v) for k, v in m.items()}
                           for name, m in metrics.items()})
        if (s + 1) % every == 0:
            ref = vectors(runs["jax"].params)
            others = {name: vectors(runs[name].params)
                      for name in ("ulp", "kick")}
            others["port"] = module_vectors(state.gen.state_dict(),
                                            state.critic.state_dict())
            moved = {m: np.linalg.norm(ref[m] - theta0[m]) for m in MODULES}
            snaps.append({"step": s + 1, **{
                name: {m: float(np.linalg.norm(v[m] - ref[m]) / moved[m])
                       for m in MODULES} for name, v in others.items()}})
    assert state.step == int(runs["jax"].step) == n_steps
    return {"snapshots": snaps, "losses": losses}


def check(series: dict) -> list[str]:
    """The bounds of the module docstring; returns what exceeds them."""
    bad, snaps = [], series["snapshots"]
    for m in MODULES:
        base = max(max(x["ulp"][m], x["kick"][m]) for x in snaps)
        for x in snaps:
            if x["port"][m] > max(MULTIPLE * base, FLOOR):
                bad.append(f"step {x['step']} {m}: port {x['port'][m]:.3e} "
                           f"against the baselines' furthest {base:.3e}")
    last = series["losses"][-1]
    for k, v in last["jax"].items():
        scale = max(abs(d[name][k] - d["jax"][k])
                    for d in series["losses"] for name in ("ulp", "kick"))
        gap = abs(last["port"][k] - v)
        if not np.isfinite(last["port"][k]) or gap > max(
                MULTIPLE * scale, 1e-5 * (1 + abs(v))):
            bad.append(f"last step {k}: port {last['port'][k]:.6g}, jax "
                       f"{v:.6g}, baselines' largest gap {scale:.3e}")
    return bad


def report(series: dict) -> None:
    for snap in series["snapshots"]:
        print(f"step {snap['step']:4d}  " + "  ".join(
            f"{m}: port {snap['port'][m]:.3e} ulp {snap['ulp'][m]:.3e} "
            f"kick {snap['kick'][m]:.3e}" for m in MODULES))
    last = series["losses"][-1]
    print("last step: " + ", ".join(
        f"{k} port {last['port'][k]:.5g} jax {v:.5g} ulp "
        f"{last['ulp'][k]:.5g} kick {last['kick'][k]:.5g}"
        for k, v in last["jax"].items()))


@pytest.mark.parametrize("d_conditional", [True, False],
                         ids=["cond", "uncond"])
def test_vawgan_trajectory_matches_jax(d_conditional):
    """N_STEPS lockstep steps at the narrow architecture, batch 32,
    n_unroll 2: the port's parameters and last losses within the bounds of
    the module docstring against JAX's own float32 spread."""
    arch = Architecture(**SMALL, d_conditional=d_conditional)
    series = lockstep(arch, N_STEPS, EVERY)
    report(series)
    assert len(series["snapshots"]) == N_STEPS // EVERY
    bad = check(series)
    assert not bad, "\n".join(bad)


@pytest.mark.slow
def test_vawgan_trajectory_matches_jax_full_width():
    """The same lockstep at the full width of
    configs/architecture-vawgan-vcc2016.json (batch 256, n_unroll 5,
    conditioned critic) for 50 steps, snapshots every 10: slow for real,
    since a full-width VAW-GAN step takes seconds on the CPU in either
    package, and each step runs four times."""
    arch = Architecture.load(os.path.join(
        ROOT, "configs", "architecture-vawgan-vcc2016.json"))
    series = lockstep(arch, 50, 10)
    report(series)
    bad = check(series)
    assert not bad, "\n".join(bad)


# --- what the lockstep does not run: the card's Adam and the resident draws

@pytest.mark.parametrize("foreach", [False, True],
                         ids=["for-loop", "foreach"])
def test_adam_matches_optax_over_many_updates(foreach):
    """The port's Adam (``train/steps.py``: ``torch.optim.Adam`` at the
    config's lr and betas, eps 1e-8) against the JAX package's optax adam
    over ADAM_UPDATES updates of one gradient sequence (signs that turn,
    elements at 1e-10 and at 0), with PyTorch's for-loop implementation
    (the CPU's) and its foreach one (the card's default).  The gradients
    are given, so nothing amplifies rounding: at every step each
    parameter agrees within ULPS float32 spacings of its value plus
    BEYOND_LR lr (measured: 3.7e-5 lr beyond 2 spacings after 500 updates,
    either implementation; Adam's eps at 1e-6 for 1e-8 would add ~1e-6 lr
    per update on unit gradients and far more on the 1e-10 ones)."""
    import optax
    from tpuvc.train import steps as steps_lib
    arch = Architecture.load(os.path.join(
        ROOT, "configs", "architecture-vawgan-vcc2016.json"))
    lr = arch.training.lr
    rng = np.random.default_rng(3)
    shapes = [(64, 16, 7), (300,), (1, 912)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params = torch.nn.ParameterList([torch.nn.Parameter(torch.tensor(p))
                                     for p in p0])
    opt = port_steps.make_vae_optimizer(port_arch(arch), params)
    for group in opt.param_groups:
        group["foreach"] = foreach
    tx = steps_lib.make_vae_optimizer(arch)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    update = jax.jit(lambda g, st, p: tx.update(g, st, p))
    scale = np.float32([1.0, 1e-10, 0.0])
    worst = 0.0
    for i in range(ADAM_UPDATES):
        grads = []
        for s in shapes:
            g = (np.sin(0.05 * i + np.arange(np.prod(s)).reshape(s))
                 + 0.5 * rng.standard_normal(s))
            grads.append((g * scale[rng.integers(0, 3, s)]).astype(
                np.float32))
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        updates, state = update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        # beyond ULPS spacings of the value, in lr
        gap = max(float(np.max(
            np.abs(p.detach().numpy() - np.asarray(q))
            - ULPS * np.spacing(np.abs(np.asarray(q))))) / lr
            for p, q in zip(params, jp))
        assert gap <= BEYOND_LR, (i, gap)
        worst = max(worst, gap)
    print(f"Adam ({'foreach' if foreach else 'for-loop'}) against optax: "
          f"{worst:g} lr beyond {ULPS} spacings over {ADAM_UPDATES} updates")


def test_resident_draws_are_uniform_and_fresh_every_step(monkeypatch):
    """``vawgan_multistep`` (the resident path of the critic A/B) draws
    each step's n_unroll critic batches and its generator batch uniformly
    with replacement over the whole table, with the rows' own labels, and
    a fresh draw and fresh noise at every step, as
    ``tpuvc.train.steps._sample_rows`` does from ``fold_in(rng, step)``."""
    from types import SimpleNamespace
    arch = port_arch(Architecture(**SMALL))
    t = arch.training
    n_rows, n_steps = 97, 400
    seen = []

    def record(state, xc, yc, xg, yg, noise, group=None):
        seen.append((xc[..., 0].long(), yc, xg[:, 0].long(), yg,
                     noise.z_gen))
        state.step += 1
        return {}

    monkeypatch.setattr(port_steps, "vawgan_step", record)
    state = SimpleNamespace(gen=SimpleNamespace(arch=arch), step=0)
    data = torch.arange(n_rows, dtype=torch.float32)[:, None].repeat(
        1, arch.x_dim)
    labels = torch.arange(n_rows) % arch.y_dim
    port_steps.vawgan_multistep(state, data, labels, n_steps, seed=0)
    assert len(seen) == n_steps == state.step
    rows = []
    for ic, yc, ig, yg, _ in seen:
        assert ic.shape == (t.n_unroll, t.batch_size)
        assert ig.shape == (t.batch_size,)
        assert torch.equal(yc, labels[ic]) and torch.equal(yg, labels[ig])
        rows.append(torch.cat([ic.reshape(-1), ig]))
    rows = torch.stack(rows)
    counts = torch.bincount(rows.reshape(-1), minlength=n_rows).double()
    expected = rows.numel() / n_rows
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    # 96 degrees of freedom: the 1e-4 tail starts near 160
    assert chi2 < 160, chi2
    # consecutive steps share rows only by chance (1/97 per draw)
    same = (rows[1:] == rows[:-1]).double().mean()
    assert float(same) < 3 / n_rows, float(same)
    z = torch.stack([s[4] for s in seen])
    assert not any(torch.equal(z[i], z[i + 1]) for i in range(n_steps - 1))
