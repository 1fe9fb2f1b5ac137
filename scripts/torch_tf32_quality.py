"""What cuDNN's TF32 does to training quality on the card.

    python scripts/torch_tf32_quality.py [--steps 5000] [--eval_every 2500]
        [--n_inner 100] [--root DIR] [--logdir DIR] [--device cuda|cpu]

``tpuvc_torch.cli.train`` and the quality studies train with PyTorch's
default, cuDNN's TF32 on (float32 convolutions on the tensor cores, 10-bit
mantissas).  This trains ``tpuvc_torch.quality.convergence_ab``'s VAW-GAN
arm of the ``model`` A/B on the same corpus (``--root``, the study's
default), seed and milestones with ``torch.backends.cudnn.allow_tf32``
False, the setting ``chip_smoke.py``'s ``cudnn_tf32(False)`` makes, and
writes its trajectory into ``scale_validation_torch.json`` under
``convergence_ab_tf32_off``, beside ``on_minus_off``: the TF32-on arm's
MCD, DTW MCD, GV and MS-high-band ratios minus this run's at each milestone
that the record's ``convergence_ab`` VAW-GAN arm shares.  An
investigation script: the package has no such switch.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from tpuvc_torch.cli.common import apply_device  # noqa: E402
from tpuvc_torch.quality import common, convergence_ab  # noqa: E402
from tpuvc_torch.utils.config import Architecture  # noqa: E402

KEY = "convergence_ab_tf32_off"
METRICS = ("mcd_db", "mcd_dtw_db", "gv_ratio_db", "ms_highband_ratio_db")


def gaps(on: list[dict], off: list[dict]) -> list[dict]:
    """On minus off at each step both trajectories reached."""
    by_step = {m["step"]: m for m in on}
    return [{"step": m["step"],
             **{k: round(by_step[m["step"]][k] - m[k], 3) for k in METRICS}}
            for m in off if m["step"] in by_step]


def main(argv: list[str] | None = None) -> dict:
    p = convergence_ab.parser(__doc__)
    p.set_defaults(steps=5000, eval_every=2500,
                   logdir=os.path.join(common.RUNS_DIR, "vcc10_tf32_off"))
    args = p.parse_args(argv)
    device = apply_device(args)
    name, overrides = convergence_ab.arms("model")[0]
    arch = convergence_ab.arm_architecture(
        Architecture.load(common.ARCH_PATH), overrides)

    common.start_launches(device)
    data, labels = convergence_ab.prepare(args)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        traj = convergence_ab.train_arm(name, arch, data, labels, args,
                                        device)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    common.require_analysis_launches(device, "torch_tf32_quality")

    on = common.read_record(common.RECORD_PATH).get("convergence_ab", {})
    result = {"steps": args.steps, "eval_every": args.eval_every,
              "ab": "model", "style": args.style, "cudnn_tf32": False,
              "models": {name: traj},
              "on_minus_off": gaps(on.get("models", {}).get(name, []),
                                   traj)}
    common.write_record(common.RECORD_PATH, {KEY: result}, device)
    print(result)
    return result


if __name__ == "__main__":
    main()
