"""Small CPU sizes of the cells for the tests (widths cut: CPU only)."""

import copy

from benchmark import common

CORPUS = {"utts_per_request": 2, "pool": 4,
          "length_s": {"dist": "lognormal", "median": 0.5, "ln_sigma": 0.35,
                       "min": 0.4, "max": 0.6},
          "warmup_requests": 1, "check_requests": 1}
LIVE = {"streams": 3, "pool": 10,
        "length_s": {"dist": "lognormal", "median": 0.8, "ln_sigma": 0.35,
                     "min": 0.5, "max": 1.2},
        "max_audio_s": 3.0, "warmup_ticks": 1, "check_ticks": 2}
TRAIN = {"utts_per_speaker": 2, "utt_s": 0.2, "tensorboard": False}


def train_config() -> dict:
    """The training configuration at a narrow width and batch 8."""
    cfg = common.load_json("configs", "vawgan-vcc2016")
    arch = copy.deepcopy(cfg["architecture"])
    arch["encoder"]["output"] = [4, 4, 4, 4, 4]
    arch["generator"]["output"] = [4, 4, 4, 4, 1]
    arch["discriminator"]["output"] = [4, 4, 4]
    arch["z_dim"] = arch["y_emb_dim"] = 8
    arch["training"]["batch_size"] = 8
    arch["training"]["n_unroll"] = 2
    return {"architecture": arch}


def overrides(cell: str) -> dict:
    kind = common.load_json(
        "traffic", common.load_json("workloads", cell)["traffic"])["kind"]
    return {"corpus": {"traffic_overrides": CORPUS},
            "live": {"traffic_overrides": LIVE},
            "train": {"traffic_overrides": TRAIN,
                      "config_overrides": train_config()}}[kind]
