"""Training states: the modules, their optimizers and the step count.

Port of ``tpuvc/train/state.py``.  The Flax state partitions one parameter
tree into the generator (encoder + decoder) and the critic
(``split_gan_params``); here the split is structural: the generator and
the critic are two modules, each with its own Adam.  ``state_dict`` and
``load_state_dict`` are what a checkpoint holds.
"""

from __future__ import annotations

import dataclasses

import torch

from tpuvc_torch.models.vae import CVAE, Critic


@dataclasses.dataclass
class VAETrainState:
    model: CVAE
    opt: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "opt": self.opt.state_dict(), "step": self.step}

    def load_state_dict(self, d: dict) -> None:
        self.model.load_state_dict(d["model"])
        self.opt.load_state_dict(d["opt"])
        self.step = int(d["step"])


@dataclasses.dataclass
class VAWGANTrainState:
    gen: CVAE                      # encoder + decoder
    critic: Critic
    opt_g: torch.optim.Optimizer   # over the generator's parameters
    opt_d: torch.optim.Optimizer   # over the critic's
    step: int = 0

    def state_dict(self) -> dict:
        return {"gen": self.gen.state_dict(),
                "critic": self.critic.state_dict(),
                "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict(), "step": self.step}

    def load_state_dict(self, d: dict) -> None:
        self.gen.load_state_dict(d["gen"])
        self.critic.load_state_dict(d["critic"])
        self.opt_g.load_state_dict(d["opt_g"])
        self.opt_d.load_state_dict(d["opt_d"])
        self.step = int(d["step"])
