"""Loss functions of the VAE and VAW-GAN models.

Port of ``tpuvc/models/losses.py``.  The noise is an argument here: the
JAX functions draw it from a key, the trainer draws it from a seeded
``torch.Generator`` (``train/steps.py``), and the tests pass the JAX key
chain's draws.  The gradient penalty takes its inner gradient with
``torch.autograd.grad(critic(x_hat).sum(), x_hat, create_graph=True)``,
which is the reference's per-sample ``vmap(grad)``: the critic has no term
across the batch (its LayerNorms are per position and per sample), so the
gradient of the summed scores w.r.t. one sample is that sample's own.

Frozen plain copy of ``tpuvc_torch/models/losses.py`` for the benchmark's
reference: no hand kernel, nothing imported from the port.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

_LOG2PI = math.log(2.0 * math.pi)


def gaussian_kld(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, e^log_var) || N(0, I)), summed over dims, mean over batch."""
    per = 0.5 * torch.sum(torch.exp(log_var) + mu * mu - 1.0 - log_var,
                          dim=-1)
    return per.mean()


def gaussian_log_density(x: torch.Tensor, mu: torch.Tensor,
                         log_var: torch.Tensor | float = 0.0
                         ) -> torch.Tensor:
    """log N(x; mu, e^log_var) summed over dims, mean over batch (the
    decoder's likelihood is taken at unit variance, log_var = 0)."""
    lv = torch.as_tensor(log_var, dtype=x.dtype, device=x.device)
    per = -0.5 * torch.sum(_LOG2PI + lv + (x - mu) ** 2 / torch.exp(lv),
                           dim=-1)
    return per.mean()


def reparameterize(mu: torch.Tensor, log_var: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """mu + eps * e^(log_var / 2), with ``eps`` ~ N(0, I) of mu's shape."""
    return mu + eps * torch.exp(0.5 * log_var)


def wasserstein_distance(d_real: torch.Tensor,
                         d_fake: torch.Tensor) -> torch.Tensor:
    """E[D(real)] - E[D(fake)] (the critic maximizes this)."""
    return d_real.mean() - d_fake.mean()


def gradient_penalty(critic: Callable[..., torch.Tensor], eps: torch.Tensor,
                     x_real: torch.Tensor, x_fake: torch.Tensor,
                     *cond: torch.Tensor) -> torch.Tensor:
    """WGAN-GP: E[(||grad_x D(x_hat)|| - 1)^2] at x_hat = eps x_real +
    (1 - eps) x_fake, ``eps`` ~ U[0, 1) of shape [B, 1].

    ``critic`` maps a batch [B, D] (and per-sample conditioning) to [B]
    scores.  The gradient is kept in the graph, so the penalty can be
    differentiated w.r.t. the critic's parameters."""
    x_hat = (eps * x_real + (1.0 - eps) * x_fake).detach().requires_grad_()
    (grads,) = torch.autograd.grad(critic(x_hat, *cond).sum(), x_hat,
                                   create_graph=True)
    norms = torch.sqrt(torch.sum(grads * grads, dim=-1) + 1e-12)
    return ((norms - 1.0) ** 2).mean()
