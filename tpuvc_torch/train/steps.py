"""Training steps of the VAE and the VAW-GAN.

Port of ``tpuvc/train/steps.py``.  A VAW-GAN step makes ``n_unroll``
critic updates, then one generator update:

- critic: loss -W + gp_lambda GP, W = E[D(x)] - E[D(xh)], with xh made by
  the encoder and decoder under ``torch.no_grad()`` (the reference's
  stop-gradient) and GP the WGAN-GP penalty;
- generator: loss KLD - logP + alpha (-E[D(xh)]), whose gradient goes to
  the encoder and decoder only.

Each update takes its gradients with ``torch.autograd.grad`` w.r.t. its
own module's parameters, so no gradient of one loss reaches the other
module's ``.grad``, and the critic's gradient of the generator loss is
never stepped.  Adam is ``torch.optim.Adam(lr, betas=(beta1, beta2),
eps=1e-8)``: optax's ``adam`` makes the same bias-corrected update.

The noise is an argument of every step.  By default a step's noise (and,
on the resident path, its minibatch rows) is drawn from a
``torch.Generator`` on the model's device seeded from (seed, step), the
counterpart of the reference's ``fold_in(rng, step)``: a resumed run draws
what a straight run draws.

The resident path runs ``n_inner`` steps per call over a frame table on
the device, drawing each minibatch there (uniform with replacement, as
``_sample_rows``); it reads nothing back to the host inside the loop, and
returns the last step's metrics as device tensors.

Data parallel (a process-group mesh, one process per card, the
counterpart of the JAX trainer's mesh): every process steps on its own
rows of the global batch, and each update all-reduces its gradients by
hand (a SUM divided by the world size, one collective per update), so
every process applies the mean of equal shards' mean gradients: the
global batch's, as the JAX mesh's psum gives it.  DDP does not fit:
its reducer hooks ``.backward()``, and these updates take their gradients
with ``torch.autograd.grad`` (the critic's through a double backward).
Every process draws the global batch's rows and noise from the same
generator and keeps its own (``local_rows``), so the world takes the step
one process takes on the whole batch.

Training takes the default route only.  The JAX package has no gradient
through its fused kernels (``jax.grad`` of K8 ``conv_ln_lrelu`` cannot be
linearized, and neither Pallas kernel has a ``custom_vjp``), so an
architecture with ``conv_impl`` or ``d2s_impl`` "pallas" is refused; its
state dict is the default route's, so weights trained on that route serve
on either.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuvc_torch.models import losses
from tpuvc_torch.models.params import init_critic_params, init_params
from tpuvc_torch.models.vae import CVAE, Critic, make_model
from tpuvc_torch.parallel.mesh import local_rows
from tpuvc_torch.train.state import VAETrainState, VAWGANTrainState
from tpuvc_torch.utils.config import Architecture
from tpuvc_torch.utils.device import resolve
from tpuvc_torch.utils.profiling import span


def check_routes(arch: Architecture) -> None:
    """Refuse the fused-kernel routes: the reference cannot train them."""
    for field in ("conv_impl", "d2s_impl"):
        if getattr(arch, field) == "pallas":
            raise ValueError(
                f"{field}='pallas' cannot be trained: the JAX package takes "
                "no gradient through its fused kernels (K8 conv_ln_lrelu, "
                "K9 d2s_ln_lrelu have no VJP), so training runs the default "
                f"route; train with {field}='xla' (the state dict is the "
                "same, so the weights serve on either route)")


def _adam(arch: Architecture, params) -> torch.optim.Adam:
    t = arch.training
    return torch.optim.Adam(params, lr=t.lr, betas=(t.beta1, t.beta2),
                            eps=1e-8)


def make_vae_optimizer(arch: Architecture, model: CVAE) -> torch.optim.Adam:
    return _adam(arch, model.parameters())


def make_gan_optimizers(arch: Architecture, gen: CVAE, critic: Critic
                        ) -> tuple[torch.optim.Adam, torch.optim.Adam]:
    return _adam(arch, gen.parameters()), _adam(arch, critic.parameters())


def vae_state(arch: Architecture, params: dict[str, torch.Tensor],
              device: torch.device | str = "cuda") -> VAETrainState:
    """A VAE training state at step 0 holding ``params`` on ``device``."""
    check_routes(arch)
    model = make_model(arch)
    model.load_state_dict(params)
    model.to(resolve(device))
    return VAETrainState(model, make_vae_optimizer(arch, model))


def vawgan_state(arch: Architecture, gen_params: dict[str, torch.Tensor],
                 critic_params: dict[str, torch.Tensor],
                 device: torch.device | str = "cuda") -> VAWGANTrainState:
    """A VAW-GAN training state at step 0 holding the generator's and the
    critic's parameters on ``device``."""
    check_routes(arch)
    device = resolve(device)
    gen = make_model(arch)
    gen.load_state_dict(gen_params)
    critic = Critic(arch)
    critic.load_state_dict(critic_params)
    gen.to(device)
    critic.to(device)
    return VAWGANTrainState(gen, critic, *make_gan_optimizers(arch, gen,
                                                              critic))


def init_vae_state(arch: Architecture, seed: int,
                   device: torch.device | str = "cuda") -> VAETrainState:
    g = torch.Generator().manual_seed(seed)
    return vae_state(arch, init_params(arch, g, "cpu"), device)


def init_vawgan_state(arch: Architecture, seed: int,
                      device: torch.device | str = "cuda"
                      ) -> VAWGANTrainState:
    g = torch.Generator().manual_seed(seed)
    gen = init_params(arch, g, "cpu")
    return vawgan_state(arch, gen, init_critic_params(arch, g, "cpu"),
                        device)


# --- noise ----------------------------------------------------------------

def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
    """The generator of step ``step``'s draws, seeded from (seed, step)."""
    (s,) = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(s))


@dataclasses.dataclass
class VAWGANNoise:
    z_crit: torch.Tensor   # [n_unroll, B, z_dim] N(0, 1): the critic updates'
    gp: torch.Tensor       # [n_unroll, B, 1] U[0, 1): their penalty mixes
    z_gen: torch.Tensor    # [B, z_dim] N(0, 1): the generator update's

    def rows(self, sl: slice) -> "VAWGANNoise":
        """The noise of batch rows ``sl``."""
        return VAWGANNoise(self.z_crit[:, sl], self.gp[:, sl],
                           self.z_gen[sl])


def vae_noise(gen: torch.Generator, batch: int,
              arch: Architecture) -> torch.Tensor:
    return torch.randn((batch, arch.z_dim), generator=gen,
                       device=gen.device)


def vawgan_noise(gen: torch.Generator, batch: int,
                 arch: Architecture) -> VAWGANNoise:
    n, z = arch.training.n_unroll, arch.z_dim
    dev = gen.device
    return VAWGANNoise(
        torch.randn((n, batch, z), generator=gen, device=dev),
        torch.rand((n, batch, 1), generator=gen, device=dev),
        torch.randn((batch, z), generator=gen, device=dev))


# --- losses and updates ---------------------------------------------------

def critic_loss(gen: CVAE, critic: Critic, x: torch.Tensor, y: torch.Tensor,
                eps_z: torch.Tensor, eps_gp: torch.Tensor, gp_lambda: float
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    with torch.no_grad():
        xh = gen(x, y, eps_z)["xh"]
    w = losses.wasserstein_distance(critic(x, y), critic(xh, y))
    gp = losses.gradient_penalty(critic, eps_gp, x, xh, y)
    loss = -w + gp_lambda * gp
    return loss, {"W_dist": w, "GP": gp, "l_D": loss}


def generator_loss(gen: CVAE, critic: Critic, x: torch.Tensor,
                   y: torch.Tensor, eps_z: torch.Tensor, alpha: float
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    out = gen(x, y, eps_z)
    kld = losses.gaussian_kld(out["z_mu"], out["z_lv"])
    logp = losses.gaussian_log_density(x, out["xh"])
    adv = -critic(out["xh"], y).mean()
    loss = kld - logp + alpha * adv
    return loss, {"D_KL": kld, "logP": logp, "l_G": loss, "adv": adv}


def all_reduce_mean(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The mean of ``tensors`` over the processes of ``group``: one SUM
    all-reduce of their concatenation, divided by the world size."""
    dist = torch.distributed
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def _update(opt: torch.optim.Optimizer, module: torch.nn.Module,
            loss: torch.Tensor, group=None) -> None:
    """One optimizer step on ``module``'s parameters along the gradient of
    ``loss`` w.r.t. them only; with a process ``group``, along that
    gradient's mean over the group."""
    params = list(module.parameters())
    grads = torch.autograd.grad(loss, params)
    if group is not None:
        grads = all_reduce_mean(list(grads), group)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def _detach(m: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in m.items()}


def vae_step(state: VAETrainState, x: torch.Tensor, y: torch.Tensor,
             eps: torch.Tensor, group=None) -> dict[str, torch.Tensor]:
    """One VAE update with the noise ``eps`` [B, z_dim]; returns
    {D_KL, logP, loss} of these rows as device tensors.  With a process
    ``group``, the rows are this process's share of the global batch and
    the gradient is the group's mean."""
    metrics, _ = state.model.loss(x, y, eps)
    _update(state.opt, state.model, metrics["loss"], group)
    state.step += 1
    return _detach(metrics)


def vawgan_step(state: VAWGANTrainState, x_crit: torch.Tensor,
                y_crit: torch.Tensor, x_gen: torch.Tensor,
                y_gen: torch.Tensor, noise: VAWGANNoise, group=None
                ) -> dict[str, torch.Tensor]:
    """One VAW-GAN step: a critic update on each of the ``n_unroll``
    batches ``x_crit`` [n_unroll, B, D], then a generator update on
    ``x_gen`` [B, D].  Returns {W_dist, GP, l_D} of the last critic update
    and {D_KL, logP, l_G, adv} as device tensors.  With a process
    ``group``, as ``vae_step``."""
    t = state.gen.arch.training
    for k in range(x_crit.shape[0]):
        with span("train.critic"):
            loss, d_aux = critic_loss(state.gen, state.critic, x_crit[k],
                                      y_crit[k], noise.z_crit[k],
                                      noise.gp[k], t.gp_lambda)
            _update(state.opt_d, state.critic, loss, group)
    with span("train.generator"):
        loss, g_aux = generator_loss(state.gen, state.critic, x_gen, y_gen,
                                     noise.z_gen, t.alpha)
        _update(state.opt_g, state.gen, loss, group)
    state.step += 1
    return _detach({**d_aux, **g_aux})


# --- the resident path ----------------------------------------------------

def vae_multistep(state: VAETrainState, data: torch.Tensor,
                  labels: torch.Tensor, n_inner: int, seed: int,
                  mesh=None) -> dict[str, torch.Tensor]:
    """``n_inner`` VAE steps over the device-resident table ``data`` [F, D]
    / ``labels`` [F]; the last step's metrics.  On a process-group
    ``mesh`` each process draws the global rows and noise and steps on its
    share."""
    arch = state.model.arch
    b = arch.training.batch_size
    mine = local_rows(mesh, b)
    group = None if mesh is None else mesh.group
    for _ in range(n_inner):
        g = step_generator(seed, state.step, data.device)
        idx = torch.randint(0, data.shape[0], (b,), generator=g,
                            device=data.device)[mine]
        metrics = vae_step(state, data[idx], labels[idx],
                           vae_noise(g, b, arch)[mine], group)
    return metrics


def vawgan_multistep(state: VAWGANTrainState, data: torch.Tensor,
                     labels: torch.Tensor, n_inner: int, seed: int,
                     mesh=None) -> dict[str, torch.Tensor]:
    """``n_inner`` VAW-GAN steps over the device-resident table; each step
    draws ``n_unroll`` critic batches and one generator batch (on a
    process-group ``mesh``, as ``vae_multistep``)."""
    arch = state.gen.arch
    t = arch.training
    b = t.batch_size
    mine = local_rows(mesh, b)
    group = None if mesh is None else mesh.group
    for _ in range(n_inner):
        g = step_generator(seed, state.step, data.device)
        ic = torch.randint(0, data.shape[0], (t.n_unroll, b), generator=g,
                           device=data.device)[:, mine]
        ig = torch.randint(0, data.shape[0], (b,), generator=g,
                           device=data.device)[mine]
        metrics = vawgan_step(state, data[ic], labels[ic], data[ig],
                              labels[ig],
                              vawgan_noise(g, b, arch).rows(mine), group)
    return metrics
