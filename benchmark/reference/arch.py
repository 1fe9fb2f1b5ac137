"""The model architecture record and its JSON form.

Frozen plain copy of ``tpuvc_torch/utils/config.py`` for the benchmark's
reference: the same field names, defaults and JSON rules.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class NetSpec:
    """Conv stack spec: per-layer kernel length (freq axis), stride, width."""

    kernel: tuple[int, ...]
    stride: tuple[int, ...]
    output: tuple[int, ...]

    def __post_init__(self):
        if not (len(self.kernel) == len(self.stride) == len(self.output)):
            raise ValueError("kernel/stride/output must have equal length")

    @staticmethod
    def from_json(d: dict[str, Any]) -> "NetSpec":
        def flat(v):
            # accept reference-style [[7,1],[7,1],...] or flat [7,7,...]
            return tuple(k[0] if isinstance(k, (list, tuple)) else k
                         for k in v)
        return NetSpec(kernel=flat(d["kernel"]), stride=flat(d["stride"]),
                       output=tuple(d["output"]))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 256
    lr: float = 1e-4
    beta1: float = 0.5
    beta2: float = 0.9
    epoch: int = 200
    alpha: float = 50.0          # adversarial weight in the generator loss
    gp_lambda: float = 10.0      # WGAN gradient penalty
    n_unroll: int = 5            # critic steps per generator step
    summary_freq: int = 100
    save_freq: int = 10000
    num_frames_per_epoch: int = 500_000

    @staticmethod
    def from_json(d: dict[str, Any]) -> "TrainConfig":
        return TrainConfig(
            batch_size=int(d.get("batch_size", 256)),
            lr=float(d.get("lr", 1e-4)),
            beta1=float(d.get("beta1", 0.5)),
            beta2=float(d.get("beta2", 0.9)),
            epoch=int(d.get("epoch", 200)),
            alpha=float(d.get("alpha", 50.0)),
            gp_lambda=float(d.get("lambda", d.get("gp_lambda", 10.0))),
            n_unroll=int(d.get("n_unroll", 5)),
            summary_freq=int(d.get("summary_freq", 100)),
            save_freq=int(d.get("save_freq", 10000)),
            num_frames_per_epoch=int(d.get("num_frames_per_epoch", 500_000)),
        )


@dataclasses.dataclass(frozen=True)
class Architecture:
    """Full model architecture (architecture-*.json)."""

    model: str = "VAWGAN"
    trainer: str = "VAWGANTrainer"
    x_dim: int = 513
    z_dim: int = 128
    y_dim: int = 10                       # number of speakers
    y_emb_dim: int = 128
    encoder: NetSpec = NetSpec((7, 7, 7, 7, 7), (3, 3, 3, 3, 3),
                               (16, 32, 64, 128, 256))
    # upsampling strides compose to 27 = 513/19 (see models/vae.py Decoder)
    generator: NetSpec = NetSpec((7, 7, 7, 7, 7), (3, 3, 3, 1, 1),
                                 (128, 64, 32, 16, 1))
    discriminator: NetSpec = NetSpec((7, 7, 7), (3, 3, 3), (16, 32, 64))
    d_conditional: bool = True            # speaker-condition the critic
    output_activation: str = "tanh"       # "tanh" or "linear" decoder head
    lrelu_slope: float = 0.2
    compute_dtype: str = "float32"        # "bfloat16" on the card
    conv_impl: str = "xla"                # "pallas": fused conv+LN+lrelu
    d2s_impl: str = "xla"                 # "pallas": fused d2s+LN+lrelu
    training: TrainConfig = TrainConfig()

    @staticmethod
    def from_json(d: dict[str, Any]) -> "Architecture":
        kw: dict[str, Any] = {}
        for key in ("model", "trainer", "x_dim", "z_dim", "y_dim",
                    "y_emb_dim", "d_conditional", "output_activation",
                    "lrelu_slope", "compute_dtype", "conv_impl", "d2s_impl"):
            if key in d:
                kw[key] = d[key]
        # a file without these fields predates them: its checkpoint was
        # trained with a linear decoder head and an unconditioned critic
        kw.setdefault("output_activation", "linear")
        kw.setdefault("d_conditional", False)
        if "hwc" in d:                    # reference alias: [513, 1, 1]
            kw["x_dim"] = int(d["hwc"][0])
        for net in ("encoder", "generator", "discriminator"):
            if net in d:
                kw[net] = NetSpec.from_json(d[net])
        if "training" in d:
            kw["training"] = TrainConfig.from_json(d["training"])
        return Architecture(**kw)

    @staticmethod
    def load(path: str) -> "Architecture":
        with open(path) as f:
            return Architecture.from_json(json.load(f))

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        for net in ("encoder", "generator", "discriminator"):
            d[net] = {k: list(v) for k, v in d[net].items()}
        return d

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)


def load_architecture(path: str) -> Architecture:
    return Architecture.load(path)
