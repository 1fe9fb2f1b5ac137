"""Parameters for the port's VAW-GAN: from a Flax tree, or a seeded init.

``from_flax`` maps the tree of ``tpuvc.models.vae.init_params`` (as numpy
arrays) onto :class:`tpuvc_torch.models.vae.VAWGAN`'s state dict:
Flax ``Conv`` kernels [K, Cin, Cout] become ``conv1d`` weights
[Cout, Cin, K], ``Dense`` kernels [in, out] become ``linear`` weights
[out, in], and LayerNorm scale/bias and the embedding table are taken as
they are.  The critic's parameters are not used.  The fused-kernel
architecture (``conv_impl``/``d2s_impl="pallas"``) names its parameters
otherwise in Flax (``ConvStack_0/conv{i}_kernel``, ``ln{i}_scale``,
``decoder/d2s_ln{i}_scale``, and the remaining decoder LayerNorms counted
without the fused ones) but maps onto the same state dict.

``init_params`` draws a full-width model from a ``torch.Generator``
(LeCun-normal weights like Flax's defaults, zero biases, unit norms), for
runs where no JAX is at hand to make the weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuvc_torch.models.vae import VAWGAN
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


def init_params(arch: Architecture, generator: torch.Generator,
                device: torch.device | str = "cuda"
                ) -> dict[str, torch.Tensor]:
    """Seeded full-width parameters for ``VAWGAN(arch)``, drawn from the
    CPU ``generator`` and placed on ``device`` (the card by default)."""
    device = resolve(device)
    shapes = VAWGAN(arch).state_dict()
    sd = {}
    for name, ref in shapes.items():
        if name.endswith("bias"):
            t = torch.zeros(ref.shape)
        elif "norm" in name:
            t = torch.ones(ref.shape)
        else:
            # LeCun normal: fan_in is every dim but the output one
            fan_in = (ref.shape[1] * (ref.shape[2] if ref.dim() == 3 else 1)
                      if name != "decoder.embed" else 1)
            std = 1.0 / math.sqrt(fan_in)
            t = torch.randn(ref.shape, generator=generator) * std
        sd[name] = t.to(device)
    return sd


def load_model(arch: Architecture, state: dict[str, torch.Tensor],
               device: torch.device | str = "cuda") -> VAWGAN:
    """A ``VAWGAN(arch)`` on ``device`` (the card by default) holding
    ``state``, in eval mode."""
    device = resolve(device)
    model = VAWGAN(arch)
    model.load_state_dict(state)
    return model.to(device).eval()
