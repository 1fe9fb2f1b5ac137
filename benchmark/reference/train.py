"""Plain VAW-GAN training steps: what ``VAWGANTrainer.train`` promises,
worked out again from the frame table, the seeds and the first weights.

A step draws ``n_unroll + 1`` minibatches from the epoch-shuffled stream
(``np.random.default_rng(seed)`` permutations, rows gathered and
Tanhize-normalised on the host), then ``n_unroll`` critic updates (loss
-W + lambda GP, the generated rows made without gradients) and one
generator update (loss KLD - logP + alpha (-E[D(xh)])), each an Adam step
(eps 1e-8) along its own module's gradient.  The noise of step s comes
from a ``torch.Generator`` on the device seeded by
``SeedSequence([seed, s])``.  Frozen plain copies of the port's
``data/dataset.py`` order, ``train/steps.py`` and ``models/losses.py``;
nothing is imported from the port.
"""

from __future__ import annotations

import numpy as np
import torch

from . import losses
from .arch import Architecture
from .model import VAWGAN, Critic


class Batches:
    """The epoch-shuffled minibatch stream over ``x`` [F, D], ``y`` [F]."""

    def __init__(self, x, y, batch: int, seed: int, xmin, xmax):
        self.x, self.y, self.batch = x, y, batch
        self.lo = np.asarray(xmin)
        self.span = np.maximum(np.asarray(xmax) - self.lo, 1e-6)
        self.rng = np.random.default_rng(seed)
        self.end = len(x) - len(x) % batch
        self.perm = self.rng.permutation(len(x))
        self.i = 0

    def __next__(self):
        if self.i >= self.end:
            self.perm = self.rng.permutation(len(self.x))
            self.i = 0
        idx = self.perm[self.i:self.i + self.batch]
        self.i += self.batch
        u = (self.x[idx].astype(np.float32) - self.lo) / self.span
        return ((np.clip(u, 0.0, 1.0) * 2.0 - 1.0).astype(np.float32),
                self.y[idx])


def step_noise(seed: int, step: int, arch: Architecture, batch: int,
               device):
    (s,) = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    g = torch.Generator(device=device).manual_seed(int(s))
    n, z = arch.training.n_unroll, arch.z_dim
    return (torch.randn((n, batch, z), generator=g, device=device),
            torch.rand((n, batch, 1), generator=g, device=device),
            torch.randn((batch, z), generator=g, device=device))


class Trainer:
    """The reference VAW-GAN trainer; ``rows`` < 1 keeps that share of each
    batch (a planted fault: the mean over part of the batch)."""

    def __init__(self, arch: Architecture, gen_state: dict,
                 critic_state: dict, device, rows: float = 1.0):
        self.arch = arch
        self.device = torch.device(device)
        self.gen = VAWGAN(arch)
        self.gen.load_state_dict(gen_state)
        self.critic = Critic(arch)
        self.critic.load_state_dict(critic_state)
        self.gen.to(self.device)
        self.critic.to(self.device)
        t = arch.training
        adam = lambda m: torch.optim.Adam(  # noqa: E731
            m.parameters(), lr=t.lr, betas=(t.beta1, t.beta2), eps=1e-8)
        self.opt_g, self.opt_d = adam(self.gen), adam(self.critic)
        self.rows = rows

    def _update(self, opt, module, loss):
        params = list(module.parameters())
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def step(self, batches: list, noise) -> dict:
        """One step on ``batches`` (n_unroll critic batches, then the
        generator's) with ``noise``; the last critic loss and the
        generator loss, each with the sum of its terms' magnitudes."""
        t = self.arch.training
        z_crit, gp_mix, z_gen = noise
        keep = max(1, int(round(self.rows * len(batches[0][0]))))
        put = lambda b: (  # noqa: E731
            torch.as_tensor(b[0][:keep], device=self.device),
            torch.as_tensor(b[1][:keep], device=self.device).long())
        for k in range(t.n_unroll):
            x, y = put(batches[k])
            with torch.no_grad():
                xh = self.gen(x, y, z_crit[k][:keep])["xh"]
            w = losses.wasserstein_distance(self.critic(x, y),
                                            self.critic(xh, y))
            gp = losses.gradient_penalty(self.critic, gp_mix[k][:keep], x,
                                         xh, y)
            l_d = -w + t.gp_lambda * gp
            self._update(self.opt_d, self.critic, l_d)
        x, y = put(batches[-1])
        out = self.gen(x, y, z_gen[:keep])
        kld = losses.gaussian_kld(out["z_mu"], out["z_lv"])
        logp = losses.gaussian_log_density(x, out["xh"])
        adv = -self.critic(out["xh"], y).mean()
        l_g = kld - logp + t.alpha * adv
        self._update(self.opt_g, self.gen, l_g)
        f = lambda v: float(v.detach())  # noqa: E731
        # each loss beside the sum of its terms' magnitudes: the critic's
        # loss -W + lambda GP can cancel to near zero, its terms do not
        return {"l_D": f(l_d), "l_G": f(l_g),
                "l_D_scale": abs(f(w)) + t.gp_lambda * abs(f(gp)),
                "l_G_scale": abs(f(kld)) + abs(f(logp)) + t.alpha * abs(f(adv))}

    def first_moments(self) -> dict:
        """Each leaf's Adam first moment, by the state-dict name."""
        out = {}
        for prefix, mod, opt in (("gen.", self.gen, self.opt_g),
                                 ("critic.", self.critic, self.opt_d)):
            for name, p in mod.named_parameters():
                out[prefix + name] = opt.state[p]["exp_avg"].detach().clone()
        return out

    def params(self) -> dict:
        out = {"gen." + k: v.detach().clone()
               for k, v in self.gen.named_parameters()}
        out.update({"critic." + k: v.detach().clone()
                    for k, v in self.critic.named_parameters()})
        return out


def leaf_gaps(got: dict, want: dict, keep: list[str]) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double()))
             for k in keep}
    med = float(np.median(list(norms.values())))
    worst = 0.0
    for k in keep:
        g = float(torch.linalg.vector_norm(got[k].double()))
        worst = max(worst, abs(g - norms[k]) / max(norms[k], med, 1e-30))
    return worst
