"""Corpus analysis CLI (the reference's ``python analyzer.py``).

  python -m tpuvc_torch.cli.analyze --corpus dataset/vcc2016 [--splits both]
      [--device cuda|cpu]

Port of ``tpuvc/cli/analyze.py`` with the same flags and checks; the
analysis runs on the CUDA card unless ``--device`` names another.  Walks
<corpus>/wav/{Training Set,Testing Set}/<SPK>/*.wav, writes
reference-layout .bin frame records under <corpus>/bin/... and stats under
<corpus>/etc/ (SURVEY.md SS3.1).
"""

from __future__ import annotations

import argparse

from tpuvc_torch.cli.common import add_device_flag, apply_device


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--corpus", required=True, help="corpus root directory")
    p.add_argument("--splits", default="both",
                   choices=["train", "test", "both"])
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--frame-period-ms", type=float, default=5.0)
    p.add_argument("--bucket-s", type=float, default=1.0,
                   help="utterance padding bucket in seconds")
    p.add_argument("--f0-method", default="dio", choices=["dio", "harvest"],
                   help="f0 estimator: dio+stonemask (reference wav2pw "
                        "default) or harvest (pyworld's alternative)")
    p.add_argument("--ap-method", default="group_delay",
                   choices=["group_delay", "nccf"],
                   help="D4C band statistic (group_delay = WORLD parity)")
    p.add_argument("--quiet", action="store_true")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = apply_device(args)

    from tpuvc_torch.data.analyze_corpus import analyze_corpus
    from tpuvc_torch.dsp.constants import (SP_DIM, WorldConfig,
                                           cheaptrick_fft_size)
    from tpuvc_torch.io import corpus as corpus_io

    # Derive the FFT size from fs (WORLD's rule) instead of silently keeping
    # the 16 kHz default: at e.g. fs=44100 a 1024-point FFT raises
    # CheapTrick's f0 low limit above genuinely voiced frames.  The .bin
    # record format (SURVEY.md SS2.1) pins SP_DIM=513, so sample rates whose
    # derived geometry differs are rejected rather than silently degraded.
    fft_size = cheaptrick_fft_size(args.fs)
    if fft_size // 2 + 1 != SP_DIM:
        p.error(
            f"fs={args.fs} requires fft_size={fft_size} "
            f"({fft_size // 2 + 1} spectral bins), but the reference record "
            f"format is pinned at {SP_DIM} bins (fft 1024); supported rates "
            f"satisfy cheaptrick_fft_size(fs) == 1024 (e.g. 16000, 22050)")
    if args.f0_method == "harvest":
        hop = int(args.fs * args.frame_period_ms / 1000.0)
        if args.fs % 1000 or (hop * 1000) % args.fs:
            p.error(
                f"--f0-method harvest needs fs divisible by 1000 and a "
                f"whole-ms frame period (its internal grid is 1 ms); got "
                f"fs={args.fs}, frame_period={args.frame_period_ms} ms — "
                f"use --f0-method dio for this rate")
    cfg = WorldConfig(fs=args.fs, frame_period_ms=args.frame_period_ms,
                      fft_size=fft_size, f0_method=args.f0_method,
                      ap_method=args.ap_method)
    splits = {"train": (corpus_io.TRAIN_SPLIT,),
              "test": (corpus_io.TEST_SPLIT,),
              "both": (corpus_io.TRAIN_SPLIT, corpus_io.TEST_SPLIT)}[
        args.splits]
    analyze_corpus(args.corpus, cfg, splits=splits, bucket_s=args.bucket_s,
                   verbose=not args.quiet, device=device)
    if not args.quiet:
        print(f"[analyze] done: records under {args.corpus}/bin, stats "
              f"under {args.corpus}/etc")


if __name__ == "__main__":
    main()
