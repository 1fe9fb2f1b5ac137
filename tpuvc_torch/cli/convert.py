"""Conversion CLI (the reference's ``python convert.py``).

  python -m tpuvc_torch.cli.convert --src SF1 --trg TM3 \
      --checkpoint logdir/train/<ts> --corpus dataset/vcc2016 \
      [--file_pattern "*.wav"] [--output DIR] [--split test] [--all_pairs] \
      [--streaming] [--data_parallel] [--vocoder-checkpoint PATH] \
      [--device cuda|cpu]

Port of ``tpuvc/cli/convert.py`` with the same flags, ``--device`` in
place of ``--platform``: conversion runs on the CUDA card unless
``--device`` names another.  Loads the run's architecture and newest
checkpoint (``ckpt/<step>.pt``, written by ``tpuvc_torch.cli.train``),
then converts every matching source-speaker utterance (analysis ->
encode -> speaker-swap decode -> f0 transform -> synthesis) and writes
<output>/<trg>-<utt>.wav, or <src>-to-<trg>-<utt>.wav for every ordered
pair of speakers under ``--all_pairs`` (with ``--data_parallel``, each
batch split over every local card; on the CPU, its one device).  With
``--vocoder-checkpoint`` a trained Parallel WaveGAN generator
(``models/pwg.py:save``: its spec and state dict) makes the waveform from
the converted features in place of WORLD's synthesis (whole utterances
only, not ``--streaming``).  The JAX
package's Orbax checkpoints cannot be read without JAX: the port neither
reads nor writes them.
"""

from __future__ import annotations

import argparse
import fnmatch
import os

from tpuvc_torch.cli.common import add_device_flag, apply_device


def load_converter(checkpoint_dir: str, corpus_root: str,
                   f0_method: str = "dio", ap_method: str = "group_delay",
                   transfer_encoding: str = "float32",
                   harvest_decim: int = 1, device="cuda",
                   vocoder_checkpoint: str | None = None):
    """(Converter, step) from a training run dir + corpus etc/ stats.

    The generator is the checkpoint's "gen" entry (VAW-GAN run) or
    "model" entry (VAE run), loaded into ``VAWGAN(arch)`` on ``device``;
    ``vocoder_checkpoint`` names a Parallel WaveGAN checkpoint
    (``models/pwg.py:save``) loaded beside it in the model's compute
    type."""
    import dataclasses

    from tpuvc_torch.convert.pipeline import Converter, ConverterAssets
    from tpuvc_torch.dsp.constants import DEFAULT_WORLD
    from tpuvc_torch.io import corpus as corpus_io
    from tpuvc_torch.models import pwg
    from tpuvc_torch.models.params import load_model
    from tpuvc_torch.train.checkpoint import latest_state_dict
    from tpuvc_torch.utils.config import Architecture

    arch = Architecture.load(os.path.join(checkpoint_dir,
                                          "architecture.json"))
    restored = latest_state_dict(os.path.join(checkpoint_dir, "ckpt"))
    if restored is None:
        raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}/ckpt")
    state, step = restored
    model = load_model(arch, state["gen" if arch.model == "VAWGAN"
                                   else "model"], device)

    etc = os.path.join(corpus_root, "etc")
    xmin, xmax = corpus_io.load_norm_stats(etc)
    mu, sigma = corpus_io.load_f0_stats(etc)
    assets = ConverterAssets(xmin=xmin, xmax=xmax, f0_mu=mu, f0_sigma=sigma,
                             speakers=corpus_io.read_speakers(etc))
    cfg = dataclasses.replace(DEFAULT_WORLD, f0_method=f0_method,
                              ap_method=ap_method,
                              harvest_channel_decim=harvest_decim)
    vocoder = (None if vocoder_checkpoint is None else pwg.load(
        vocoder_checkpoint, device, arch.compute_dtype))
    return Converter(model, assets, cfg=cfg,
                     transfer_encoding=transfer_encoding,
                     device=device, vocoder=vocoder), step


def main(argv: list[str] | None = None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--src", default=None)
    p.add_argument("--trg", default=None)
    p.add_argument("--all_pairs", action="store_true",
                   help="convert every source speaker's utterances to every "
                        "other speaker in batched calls; ignores "
                        "--src/--trg")
    p.add_argument("--checkpoint", required=True,
                   help="training run directory (logdir/train/<ts>)")
    p.add_argument("--corpus", required=True)
    p.add_argument("--file_pattern", default="*.wav")
    p.add_argument("--split", default="test", choices=["train", "test"])
    p.add_argument("--output", default=None,
                   help="default: <checkpoint>/converted")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_spectrogram", action="store_true",
                   help="also write a jet spectrogram PNG per converted wav "
                        "(needs matplotlib; skipped without it)")
    p.add_argument("--streaming", action="store_true",
                   help="convert through the chunked streaming path "
                        "(convert/streaming.py) instead of whole utterances")
    p.add_argument("--chunk_s", type=float, default=1.0,
                   help="streaming chunk seconds (with --streaming)")
    p.add_argument("--f0-method", default="dio", choices=["dio", "harvest"],
                   help="f0 estimator of the conversion (match what "
                        "cli.analyze used for the corpus stats)")
    p.add_argument("--ap-method", default="group_delay",
                   choices=["group_delay", "nccf"])
    p.add_argument("--harvest-decim", type=int, default=1,
                   help="harvest fast mode: candidate filterbank at "
                        "1/(40/decim) octave (2 halves the band bank and the "
                        "event tracks); 1 = exact WORLD layout")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard batched (--all_pairs) conversion over all "
                        "local cards (one model replica and one shard of "
                        "each batch per card)")
    p.add_argument("--transfer-encoding", default="float32",
                   choices=["float32", "ulaw8", "pcm12"],
                   help="device->host waveform encoding (ops/ulaw.py): "
                        "ulaw8 = 8-bit mu-law, pcm12 = packed 12-bit PCM; "
                        "written WAVs are 16-bit either way")
    p.add_argument("--vocoder-checkpoint", default=None,
                   help="a Parallel WaveGAN generator (models/pwg.py:save: "
                        "spec and state dict) that makes the waveform in "
                        "place of WORLD's synthesis")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = apply_device(args)

    from tpuvc_torch.io import corpus as corpus_io
    from tpuvc_torch.io.wav import read_wav, write_wav

    converter, step = load_converter(args.checkpoint, args.corpus,
                                     args.f0_method, args.ap_method,
                                     args.transfer_encoding,
                                     args.harvest_decim, device,
                                     args.vocoder_checkpoint)
    split = (corpus_io.TEST_SPLIT if args.split == "test"
             else corpus_io.TRAIN_SPLIT)
    out_dir = args.output or os.path.join(args.checkpoint, "converted")
    os.makedirs(out_dir, exist_ok=True)

    if args.all_pairs:
        speakers = converter.assets.speakers
        xs, srcs, trgs, names = [], [], [], []
        for src in speakers:
            for w in corpus_io.list_wavs(args.corpus, split, src):
                if not fnmatch.fnmatch(os.path.basename(w),
                                       args.file_pattern):
                    continue
                x, _ = read_wav(w, target_fs=converter.cfg.fs)
                utt = os.path.splitext(os.path.basename(w))[0]
                for trg in speakers:
                    if trg == src:
                        continue
                    xs.append(x)
                    srcs.append(src)
                    trgs.append(trg)
                    names.append(f"{src}-to-{trg}-{utt}.wav")
        outputs = []
        mesh = None
        if args.data_parallel:
            from tpuvc_torch.parallel import mesh as mesh_lib
            mesh = (mesh_lib.make_mesh() if device.type == "cuda"
                    else mesh_lib.make_mesh(devices=[device]))
        ys = converter.convert_batch(xs, srcs, trgs, seed=args.seed,
                                     mesh=mesh)
        for name, y in zip(names, ys):
            out = os.path.join(out_dir, name)
            write_wav(out, y, converter.cfg.fs)
            outputs.append(out)
        print(f"[convert] step{step} all-pairs: {len(outputs)} conversions "
              f"({len(set(srcs))} speakers) -> {out_dir}")
        return outputs

    if not args.src or not args.trg:
        p.error("--src and --trg are required unless --all_pairs is set")
    wavs = [w for w in corpus_io.list_wavs(args.corpus, split, args.src)
            if fnmatch.fnmatch(os.path.basename(w), args.file_pattern)]
    if not wavs:
        raise FileNotFoundError(
            f"no wavs for speaker {args.src} in split {split!r}")
    outputs = []
    for w in wavs:
        x, _ = read_wav(w, target_fs=converter.cfg.fs)
        if args.streaming:
            y = _stream_one(converter, x, args)
        else:
            y = converter.convert(x, args.src, args.trg, seed=args.seed)
        out = os.path.join(
            out_dir, f"{args.trg}-{os.path.splitext(os.path.basename(w))[0]}"
                     ".wav")
        write_wav(out, y, converter.cfg.fs)
        if args.save_spectrogram:
            _save_spectrogram_png(out, y, converter.device)
        outputs.append(out)
        print(f"[convert] step{step} {args.src}->{args.trg} "
              f"{os.path.basename(w)} -> {out}")
    return outputs


def _stream_one(converter, x, args):
    import numpy as np

    from tpuvc_torch.convert.streaming import StreamingConverter
    s = StreamingConverter(converter, args.src, args.trg,
                           chunk_s=args.chunk_s, cfg=converter.cfg,
                           seed=args.seed)
    return np.concatenate([s.push(x), s.flush()])


def _save_spectrogram_png(wav_path: str, y, device) -> None:
    """A jet spectrogram of the converted wav beside it; nothing without
    matplotlib."""
    try:
        from matplotlib import image as mpimg
    except ImportError:
        return
    import numpy as np

    from tpuvc_torch.data.analyze_corpus import analyze_utterance
    from tpuvc_torch.dsp.constants import DEFAULT_WORLD
    from tpuvc_torch.utils.image import spectrogram_image
    _, sp, _ = analyze_utterance(np.asarray(y, np.float64), DEFAULT_WORLD,
                                 device=device)
    mpimg.imsave(wav_path.replace(".wav", ".png"),
                 spectrogram_image(sp, log_input=True))


if __name__ == "__main__":
    main()
