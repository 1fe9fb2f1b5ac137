"""Evaluation CLI: analysis/synthesis round-trip MCD on a corpus, or
conversion MCD against parallel recordings.

  python -m tpuvc_torch.cli.evaluate --corpus dataset/vcc2016 \
      [--split test] [--limit N] [--device cuda|cpu]
  python -m tpuvc_torch.cli.evaluate --corpus dataset/vcc2016 \
      --checkpoint logdir/train/<ts> --src SF1 --trg TM3

Port of ``tpuvc/cli/evaluate.py`` with the same flags and JSON keys,
``--device`` in place of ``--platform``: the analyses, the resynthesis and
the conversion run on the CUDA card unless ``--device`` names another;
the metrics (``utils/metrics.py``) are numpy on the host.

Round trip: for every utterance analyze -> synthesize -> re-analyze, and
report the mel-cepstral distortion between the original and round-trip
spectral envelopes (the vocoder's own distortion floor).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from tpuvc_torch.cli.common import add_device_flag, apply_device


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--corpus", required=True)
    p.add_argument("--split", default="test", choices=["train", "test"])
    p.add_argument("--speaker", default=None)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--checkpoint", default=None,
                   help="evaluate CONVERSION MCD: convert every test "
                        "utterance src->trg and compare against the target "
                        "speaker's parallel recording of the same utterance")
    p.add_argument("--src", default=None)
    p.add_argument("--trg", default=None)
    p.add_argument("--f0-method", default="dio", choices=["dio", "harvest"],
                   help="f0 estimator for the conversion (match "
                        "cli.analyze)")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = apply_device(args)

    if args.checkpoint:
        return _conversion_mcd(args, device)

    import torch

    from tpuvc_torch.data.analyze_corpus import analyze_utterance
    from tpuvc_torch.dsp.constants import DEFAULT_WORLD
    from tpuvc_torch.dsp.world import WorldFeatures, resynthesize
    from tpuvc_torch.io import corpus as corpus_io
    from tpuvc_torch.io.wav import read_wav
    from tpuvc_torch.utils.metrics import mcd

    cfg = DEFAULT_WORLD
    split = (corpus_io.TEST_SPLIT if args.split == "test"
             else corpus_io.TRAIN_SPLIT)
    wavs = corpus_io.list_wavs(args.corpus, split, args.speaker)
    if args.limit:
        wavs = wavs[: args.limit]
    if not wavs:
        raise FileNotFoundError(f"no wavs in {args.corpus} split {split!r}")
    scores = []
    for w in wavs:
        x, _ = read_wav(w, target_fs=cfg.fs)
        f0, sp, ap = analyze_utterance(x, cfg, device=device)
        feats = WorldFeatures(*(torch.as_tensor(v, device=device)
                                for v in (f0, sp, ap)))
        y = resynthesize(feats, cfg, seed=0).cpu().numpy()[: len(x)]
        _, spb, _ = analyze_utterance(y, cfg, device=device)
        n = min(len(sp), len(spb))
        scores.append(mcd(sp[:n], spb[:n], cfg.fs))
    result = {"metric": "round-trip MCD", "unit": "dB",
              "mean": round(float(np.mean(scores)), 3),
              "max": round(float(np.max(scores)), 3),
              "n_utterances": len(scores)}
    print(json.dumps(result))
    return result


def _conversion_mcd(args, device) -> dict:
    """MCD between converted src->trg utterances and the target speaker's
    parallel recordings (frames aligned by truncation, an upper bound where
    the recordings' timings differ), the DTW-aligned MCD, and the
    sharpness measures: mel-cepstral GV over the pooled frames and the
    modulation spectrum's high band per utterance."""
    import os

    from tpuvc_torch.cli.convert import load_converter
    from tpuvc_torch.data.analyze_corpus import analyze_utterance
    from tpuvc_torch.dsp.constants import DEFAULT_WORLD
    from tpuvc_torch.io import corpus as corpus_io
    from tpuvc_torch.io.wav import read_wav
    from tpuvc_torch.utils.metrics import (gv_ratio_db, mcd, mcd_dtw,
                                           ms_highband_ratio_db)

    if not args.src or not args.trg:
        raise SystemExit("--checkpoint evaluation needs --src and --trg")
    cfg = DEFAULT_WORLD
    converter, step = load_converter(args.checkpoint, args.corpus,
                                     f0_method=args.f0_method, device=device)
    split = (corpus_io.TEST_SPLIT if args.split == "test"
             else corpus_io.TRAIN_SPLIT)
    src_wavs = corpus_io.list_wavs(args.corpus, split, args.src)
    if args.limit:
        src_wavs = src_wavs[: args.limit]
    scores, dtw_scores, ms_ratios = [], [], []
    sp_conv_all: list[np.ndarray] = []
    sp_trg_all: list[np.ndarray] = []
    for w in src_wavs:
        trg_w = w.replace(f"/{args.src}/", f"/{args.trg}/")
        if not os.path.exists(trg_w):
            continue
        x, _ = read_wav(w, target_fs=cfg.fs)
        y = converter.convert(x, args.src, args.trg)
        _, sp_conv, _ = analyze_utterance(y, cfg, device=device)
        xt, _ = read_wav(trg_w, target_fs=cfg.fs)
        _, sp_trg, _ = analyze_utterance(xt, cfg, device=device)
        n = min(len(sp_conv), len(sp_trg))
        scores.append(mcd(sp_conv[:n], sp_trg[:n], cfg.fs))
        dtw_scores.append(mcd_dtw(sp_conv, sp_trg, cfg.fs))
        ms_ratios.append(ms_highband_ratio_db(sp_conv, sp_trg, cfg.fs))
        sp_conv_all.append(sp_conv)
        sp_trg_all.append(sp_trg)
    gv_db = (gv_ratio_db(np.concatenate(sp_conv_all),
                         np.concatenate(sp_trg_all), cfg.fs)
             if sp_conv_all else None)
    result = {"metric": f"conversion MCD {args.src}->{args.trg} vs target "
                        "parallel recording",
              "unit": "dB", "step": int(step),
              "mean": round(float(np.mean(scores)), 3) if scores else None,
              "mean_dtw": (round(float(np.mean(dtw_scores)), 3)
                           if dtw_scores else None),
              "gv_ratio_db": round(gv_db, 3) if gv_db is not None else None,
              "ms_highband_ratio_db": (round(float(np.mean(ms_ratios)), 3)
                                       if ms_ratios else None),
              "n_utterances": len(scores)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
