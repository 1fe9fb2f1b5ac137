"""Parameters for the port's VAW-GAN: from a Flax tree, or a seeded init.

``from_flax`` maps the tree of ``tpuvc.models.vae.init_params`` (as numpy
arrays) onto :class:`tpuvc_torch.models.vae.VAWGAN`'s state dict:
Flax ``Conv`` kernels [K, Cin, Cout] become ``conv1d`` weights
[Cout, Cin, K], ``Dense`` kernels [in, out] become ``linear`` weights
[out, in], and LayerNorm scale/bias and the embedding table are taken as
they are.  The critic's parameters are not used there:
``critic_from_flax`` maps them onto :class:`Critic`'s own state dict.  The
fused-kernel
architecture (``conv_impl``/``d2s_impl="pallas"``) names its parameters
otherwise in Flax (``ConvStack_0/conv{i}_kernel``, ``ln{i}_scale``,
``decoder/d2s_ln{i}_scale``, and the remaining decoder LayerNorms counted
without the fused ones) but maps onto the same state dict.

``init_params`` (and ``init_critic_params``) draw a full-width model from a
``torch.Generator`` with Flax's initializers, for runs where no JAX is at
hand to make the weights: conv and dense kernels from a LeCun normal
truncated at two standard deviations (``jax.nn.initializers.lecun_normal``:
sigma = 1/sqrt(fan_in)/0.87962566, the truncated law's std then being
1/sqrt(fan_in)), embedding tables from an untruncated normal of std
1/sqrt(features) (Flax's ``default_embed_init``), zero biases and unit
LayerNorm scales.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuvc_torch.models.vae import VAWGAN, Critic
from tpuvc_torch.utils.config import Architecture
from tpuvc_torch.utils.device import resolve


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _conv(p) -> dict[str, torch.Tensor]:
    return {"weight": _t(p["kernel"]).permute(2, 1, 0).contiguous(),
            "bias": _t(p["bias"])}


def _dense(p) -> dict[str, torch.Tensor]:
    return {"weight": _t(p["kernel"]).T.contiguous(), "bias": _t(p["bias"])}


def _norm(p) -> dict[str, torch.Tensor]:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def from_flax(tree, arch: Architecture) -> dict[str, torch.Tensor]:
    """Flax VAWGAN/CVAE params (``{"params": ...}`` or the inner dict,
    leaves as numpy) -> state dict for ``VAWGAN(arch)``."""
    p = tree.get("params", tree)
    sd: dict[str, torch.Tensor] = {}

    def put(prefix, d):
        for k, v in d.items():
            sd[f"{prefix}.{k}"] = v

    enc = p["encoder"]
    stack = enc["ConvStack_0"]
    for i in range(len(arch.encoder.kernel)):
        if arch.conv_impl == "pallas":
            conv = {"kernel": stack[f"conv{i}_kernel"],
                    "bias": stack[f"conv{i}_bias"]}
            norm = {"scale": stack[f"ln{i}_scale"],
                    "bias": stack[f"ln{i}_bias"]}
        else:
            conv, norm = stack[f"Conv_{i}"], stack[f"LayerNorm_{i}"]
        put(f"encoder.stack.convs.{i}", _conv(conv))
        put(f"encoder.stack.norms.{i}", _norm(norm))
    put("encoder.mu", _dense(enc["Dense_0"]))
    put("encoder.log_var", _dense(enc["Dense_1"]))

    dec = p["decoder"]
    sd["decoder.embed"] = _t(dec["Embed_0"]["embedding"])
    put("decoder.dense", _dense(dec["Dense_0"]))
    put("decoder.dense_norm", _norm(dec["LayerNorm_0"]))
    n = len(arch.generator.kernel)
    ln = 1                       # LayerNorm_0 is the dense layer's
    for i, s in enumerate(arch.generator.stride):
        put(f"decoder.convs.{i}", _conv(dec[f"Conv_{i}"]))
        if i == n - 1:
            continue
        if s > 1 and arch.d2s_impl == "pallas":
            norm = {"scale": dec[f"d2s_ln{i}_scale"],
                    "bias": dec[f"d2s_ln{i}_bias"]}
        else:
            norm, ln = dec[f"LayerNorm_{ln}"], ln + 1
        put(f"decoder.norms.{i}", _norm(norm))
    return sd


def critic_from_flax(tree, arch: Architecture) -> dict[str, torch.Tensor]:
    """The Flax VAWGAN's ``critic`` subtree (of the whole tree, or the
    subtree itself; leaves as numpy) -> state dict for ``Critic(arch)``."""
    p = tree.get("params", tree)
    p = p.get("critic", p)
    sd: dict[str, torch.Tensor] = {}

    def put(prefix, d):
        for k, v in d.items():
            sd[f"{prefix}.{k}"] = v

    stack = p["ConvStack_0"]
    for i in range(len(arch.discriminator.kernel)):
        if arch.conv_impl == "pallas":
            conv = {"kernel": stack[f"conv{i}_kernel"],
                    "bias": stack[f"conv{i}_bias"]}
            norm = {"scale": stack[f"ln{i}_scale"],
                    "bias": stack[f"ln{i}_bias"]}
        else:
            conv, norm = stack[f"Conv_{i}"], stack[f"LayerNorm_{i}"]
        put(f"stack.convs.{i}", _conv(conv))
        put(f"stack.norms.{i}", _norm(norm))
    put("score", _dense(p["Dense_0"]))
    if arch.d_conditional:
        put("project", _dense(p["Dense_1"]))
        sd["embed"] = _t(p["Embed_0"]["embedding"])
    return sd


# the truncated standard normal on [-2, 2] has std 0.87962566: Flax
# divides by it so that the truncated draw keeps the std 1/sqrt(fan_in)
_TRUNC_STD = 0.87962566103423978


def _seeded(shapes: dict[str, torch.Tensor], generator: torch.Generator,
            device: torch.device) -> dict[str, torch.Tensor]:
    """Draws for a state dict's tensors, in its order, with Flax's
    initializer for each kind of tensor."""
    sd = {}
    for name, ref in shapes.items():
        if name.endswith("bias"):
            t = torch.zeros(ref.shape)
        elif "norm" in name:
            t = torch.ones(ref.shape)
        elif name.endswith("embed"):
            # default_embed_init: normal, std 1/sqrt(features)
            t = torch.randn(ref.shape, generator=generator) / math.sqrt(
                ref.shape[1])
        else:
            # lecun_normal: fan_in is every dim but the output one
            fan_in = ref[0].numel()
            std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
            t = torch.nn.init.trunc_normal_(torch.empty(ref.shape), 0.0, std,
                                            -2.0 * std, 2.0 * std,
                                            generator=generator)
        sd[name] = t.to(device)
    return sd


def init_params(arch: Architecture, generator: torch.Generator,
                device: torch.device | str = "cuda"
                ) -> dict[str, torch.Tensor]:
    """Seeded full-width parameters for ``VAWGAN(arch)``, drawn from the
    CPU ``generator`` and placed on ``device`` (the card by default)."""
    return _seeded(VAWGAN(arch).state_dict(), generator, resolve(device))


def init_critic_params(arch: Architecture, generator: torch.Generator,
                       device: torch.device | str = "cuda"
                       ) -> dict[str, torch.Tensor]:
    """Seeded parameters for ``Critic(arch)``, as ``init_params``."""
    return _seeded(Critic(arch).state_dict(), generator, resolve(device))


def load_model(arch: Architecture, state: dict[str, torch.Tensor],
               device: torch.device | str = "cuda") -> VAWGAN:
    """A ``VAWGAN(arch)`` on ``device`` (the card by default) holding
    ``state``, in eval mode."""
    device = resolve(device)
    model = VAWGAN(arch)
    model.load_state_dict(state)
    return model.to(device).eval()
