"""Round-trip fidelity across signal classes: the port of
``scripts/roundtrip_classes.py``.

    python -m tpuvc_torch.quality.roundtrip_classes [--device cuda|cpu]

Per class of ``signals.make_speech_like``: the analyze -> synthesize ->
re-analyze MCD of one utterance against the analyzer's own test-retest
floor (the same deterministic source with a fresh noise realization: the
measurement noise of the metric itself).  A round trip under 1.5x its
floor is "measurement_limited".  Runs on the card unless ``--device``
names another (the JAX script forces the CPU); writes the JAX script's
``roundtrip_by_class`` into ``common.RECORD_PATH``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from tpuvc_torch.cli.common import add_device_flag, apply_device
from tpuvc_torch.dsp.constants import DEFAULT_WORLD
from tpuvc_torch.dsp.world import analyze, resynthesize
from tpuvc_torch.quality import common
from tpuvc_torch.quality.signals import make_speech_like
from tpuvc_torch.utils.metrics import mcd

KINDS = ("sweep", "vibrato", "transitions", "low_f0", "breathy")


def _host(feats) -> tuple[np.ndarray, np.ndarray]:
    return feats.f0.cpu().numpy(), feats.sp.cpu().numpy()


def roundtrip_mcd(x, cfg, seed: int = 7, device="cuda") -> float:
    feats = analyze(np.asarray(x, np.float32), cfg, device)
    y = resynthesize(feats, cfg, seed=seed).cpu().numpy()[: len(x)]
    f0, sp = _host(feats)
    _, sp2 = _host(analyze(y.astype(np.float32), cfg, device))
    n = min(sp.shape[0], sp2.shape[0])
    v = f0[:n] > 0
    return float(mcd(sp[:n][v], sp2[:n][v], cfg.fs))


def retest_floor(kind: str, cfg, device="cuda") -> float:
    """Analyzer test-retest: same deterministic source, two noise seeds."""
    x1, _, _ = make_speech_like(kind, seed=0)
    x2, _, _ = make_speech_like(kind, seed=1)
    f1, sp1 = _host(analyze(np.asarray(x1, np.float32), cfg, device))
    f2, sp2 = _host(analyze(np.asarray(x2, np.float32), cfg, device))
    n = min(sp1.shape[0], sp2.shape[0])
    v = (f1[:n] > 0) & (f2[:n] > 0)
    return float(mcd(sp1[:n][v], sp2[:n][v], cfg.fs))


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    add_device_flag(p)
    device = apply_device(p.parse_args(argv))
    cfg = DEFAULT_WORLD
    common.start_launches(device)
    out = {}
    for kind in KINDS:
        x, _, _ = make_speech_like(kind, seed=0)
        rt = roundtrip_mcd(x, cfg, device=device)
        floor = retest_floor(kind, cfg, device)
        out[kind] = {"roundtrip_mcd_db": round(rt, 3),
                     "retest_floor_db": round(floor, 3),
                     "measurement_limited": rt < 1.5 * floor}
        print(f"[{kind}] round-trip {rt:.3f} dB vs test-retest floor "
              f"{floor:.3f} dB", flush=True)
    common.require_analysis_launches(device, "roundtrip_classes")
    common.write_record(common.RECORD_PATH, {"roundtrip_by_class": out},
                        device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
