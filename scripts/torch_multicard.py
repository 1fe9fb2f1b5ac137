"""Data parallelism across the cards of one machine: serving over a mesh of
every card, and a training step as one NCCL rank per card.

  python3 scripts/torch_multicard.py [--out DIR]
  python3 scripts/torch_multicard.py --device cpu --ranks 4 --batch 2 \
      --dur 0.5 --arch SMALL.json --utts 2          # a rehearsal on the CPU

Imports no JAX.  On a machine with N cards (N >= 2) it prints, beside the
card's name and power limit:

  - serving: ``Converter.convert_batch`` on the default and the fused path
    (full-width VAW-GAN, seeded random weights, bf16 compute), one card on
    ``--batch`` utterances of ``--dur`` s against a mesh of the N cards on
    N x ``--batch`` (each card its own ``--batch`` rows): audio s per wall
    s of both (best of 3 synchronised calls) and their ratio, beside the N
    shards' calls made in turn without threads, each on its own card; the
    mesh's first rows must equal the one card's (waveform SNR >= 40 dB);
  - training: one VAW-GAN step of the architecture ``--arch`` (the
    full-width configs/architecture-vawgan-vcc2016.json by default, float32,
    TF32 off) as N NCCL ranks, one per card, each on its share of the
    global batch, against one process on card 0: the loss dict within
    rtol 1e-3 + atol 1e-5 and the parameters under chip_smoke.py's
    ``params_agree`` rule (phase 6's), then ms per step of both over 5 more
    steps.  The batch is the first of a synthetic corpus (make_corpus's
    first 10 VCC2016-shaped speakers, ``--utts`` utterances of 1.5 s each)
    analysed by ``cli.analyze``.

With ``--device cpu`` the mesh is ``--ranks`` x ``cpu`` and the ranks use
gloo.  Any disagreement raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def serving(dev, mesh, batch: int, dur_s: float) -> dict:
    from tpuvc_torch.convert.pipeline import Converter
    n = mesh.size
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    state = cs.build_state()
    xs, src = cs.batch_of(np.random.default_rng(8), n * batch, dur_s)
    trg = [(i * 7 + 3) % 10 for i in range(n * batch)]
    names = lambda ids: [cs.SPEAKERS[i] for i in ids]  # noqa: E731
    assets = cs.make_assets(xs[:16], src[:16], cs.path_cfg("default"),
                            mesh.devices[0])
    rec = {}
    for path in ("default", "fused"):
        convs = [Converter(cs.path_model(path, state, d), assets,
                           cs.path_cfg(path), device=d)
                 for d in mesh.devices]
        conv = convs[0]

        def in_turn():
            for i, c in enumerate(convs):
                rows = slice(i * batch, (i + 1) * batch)
                c.convert_batch(xs[rows], names(src[rows]),
                                names(trg[rows]), seed=i * batch)

        calls = {
            "one": lambda: conv.convert_batch(
                xs[:batch], names(src[:batch]), names(trg[:batch]), seed=0),
            "mesh": lambda: conv.convert_batch(
                xs, names(src), names(trg), seed=0, mesh=mesh),
            "in_turn": in_turn}
        outs = {k: fn() for k, fn in calls.items()}       # warm-up
        lat = {k: [] for k in calls}
        for _ in range(3):
            for k, fn in calls.items():
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                lat[k].append(time.perf_counter() - t0)
        snr = cs.min_snr_db(outs["one"], outs["mesh"][:batch])
        rate = {"one": batch * dur_s / min(lat["one"]),
                "mesh": n * batch * dur_s / min(lat["mesh"]),
                "in_turn": n * batch * dur_s / min(lat["in_turn"])}
        rec[path] = {"audio_s_per_s": rate, "latency_s": lat,
                     "snr_db": snr}
        cs.say(f"[serving] {path}: one card, {batch} x {dur_s:g} s: "
               f"{rate['one']:.2f} audio s per wall s; a mesh of {n} "
               f"({', '.join(map(str, mesh.devices))}), {n * batch} x "
               f"{dur_s:g} s: {rate['mesh']:.2f} "
               f"({rate['mesh'] / rate['one']:.2f}x), its {n} shards' calls "
               f"in turn on their cards without threads "
               f"{rate['in_turn']:.2f} (latencies "
               + " / ".join(", ".join(f"{v:.4f}" for v in lat[k])
                            for k in calls) + " s); the "
               f"mesh's first {batch} rows against the one card's: SNR min "
               f"{snr:.1f} dB (bound 40 dB)")
        if not snr >= 40.0:
            raise AssertionError(f"{path}: the mesh and one card disagree")
        del conv, convs
    return rec


def corpus(dev, root: str, n_utts: int) -> str:
    from tpuvc_torch.cli import analyze
    from tpuvc_torch.data import synthetic
    defs = dict(list(synthetic.VCC2016_SPEAKER_DEFS.items())[:10])
    synthetic.make_corpus(root, n_train=n_utts, n_test=0, dur_s=1.5, seed=0,
                          speaker_defs=defs)
    analyze.main(["--corpus", root, "--splits", "train", "--quiet",
                  "--device", dev.type])
    return root


def training(dev, n: int, arch_path: str, root: str, n_utts: int,
             timed_steps: int = 5) -> dict:
    from tpuvc_torch.data.dataset import FrameDataset
    from tpuvc_torch.data.normalizer import Tanhize
    from tpuvc_torch.parallel import dryrun
    from tpuvc_torch.train import steps as steps_lib
    from tpuvc_torch.utils.config import Architecture
    cuda = dev.type == "cuda"
    arch = Architecture.load(arch_path)
    b = arch.training.batch_size
    data = corpus(dev, os.path.join(root, "corpus"), n_utts)
    stream = FrameDataset.from_bin_dir(data).batches(
        b, seed=0, normalizer=Tanhize.from_etc(os.path.join(data, "etc")))
    xs, ys = zip(*(next(stream) for _ in range(arch.training.n_unroll + 1)))
    batch = {"x_crit": torch.from_numpy(np.stack(xs[:-1])),
             "y_crit": torch.from_numpy(np.stack(ys[:-1])),
             "x_gen": torch.from_numpy(xs[-1]),
             "y_gen": torch.from_numpy(ys[-1])}
    noise = steps_lib.vawgan_noise(steps_lib.step_generator(0, 0, "cpu"), b,
                                   arch)
    backend = "nccl" if cuda else "gloo"
    t0 = time.perf_counter()
    ranks = dryrun.run_dp_step(
        {"arch": arch.to_json(), "params": None, "seed": 0, "batch": batch,
         "noise": noise, "device": dev.type, "backend": backend,
         "timed_steps": timed_steps}, n, root,
        env=None if cuda else {"OMP_NUM_THREADS": "1"}, timeout=900.0)
    wall = time.perf_counter() - t0
    with dryrun.strict_float32():
        st = dryrun.make_state(arch, None, 0, dev)
        seen_g, seen_d = cs.record_grads(st.opt_g), cs.record_grads(st.opt_d)
        m = {k: float(v) for k, v in dryrun.take_step(st, batch,
                                                      noise).items()}
        want = dryrun.step_params(st)
        got = ranks[0]["metrics"]
        bad = [k for k in m if abs(got[k] - m[k])
               > cs.STEP_RTOL * abs(m[k]) + cs.STEP_ATOL]
        if bad or any(not torch.equal(p, ranks[0]["params"][mod][k])
                      for r in ranks[1:] for mod, ps in r["params"].items()
                      for k, p in ps.items()):
            raise AssertionError(f"{n} ranks against one process: {bad} "
                                 f"({got} vs {m}), or the ranks differ")
        lr = arch.training.lr
        worst = {mod: cs.params_agree(
            ranks[0]["params"][mod], want[mod],
            cs.named_grads(getattr(st, mod), seen), lr, cs.PARAM_FRAC,
            cs.PARAM_TOL) for mod, seen in (("gen", seen_g),
                                            ("critic", seen_d))}
        one_ms = cs.step_ms(lambda: dryrun.take_step(st, batch, noise), dev,
                            timed_steps)
    rel = max(abs(got[k] - m[k]) / max(abs(m[k]), 1e-30) for k in m)
    ms = max(r["step_ms"] for r in ranks)
    cs.say(f"[training] VAW-GAN step ({arch_path}, batch {b}, float32, TF32 "
           f"off) as {n} {backend} ranks on "
           f"{', '.join(r['device'] for r in ranks)} ({b // n} rows each) "
           f"against one process on {dev}: ranks equal; loss dict max "
           f"relative error {rel:.3e}; parameters, in lr, generator "
           f"{worst['gen']['significant']:.3e} / {worst['gen']['rest']:.3e},"
           f" critic {worst['critic']['significant']:.3e} / "
           f"{worst['critic']['rest']:.3e} (phase 6's rule); {timed_steps} "
           f"more steps: {ms:.2f} ms per step on {n} ranks against "
           f"{one_ms:.2f} ms in one process (the ranks' call {wall:.1f} s "
           "with start-up)")
    return {"ranks": n, "backend": backend, "batch": b,
            "devices": [r["device"] for r in ranks], "max_rel_err": rel,
            "err_lr": worst, "step_ms_ranks": [r["step_ms"] for r in ranks],
            "step_ms_one": one_ms}


def main() -> int:
    from tpuvc_torch.parallel import mesh as mesh_lib
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=None,
                   help="CPU only: mesh devices and ranks (the card count "
                        "on the card)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dur", type=float, default=4.0)
    p.add_argument("--arch", default=os.path.join(cs.ROOT, cs.TRAIN_ARCH))
    p.add_argument("--utts", type=int, default=8)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        name, smi = cs.phase_device()
        if torch.cuda.device_count() < 2:
            raise SystemExit("torch_multicard: needs two CUDA cards or more")
        dev = torch.device("cuda", 0)
        mesh = mesh_lib.make_mesh()
    else:
        name = smi = "cpu"
        mesh = mesh_lib.make_mesh(devices=[dev] * (args.ranks or 4))
    rec = {"card": smi, "serving": serving(dev, mesh, args.batch, args.dur)}
    with tempfile.TemporaryDirectory() as tmp:
        rec["training"] = training(dev, mesh.size, args.arch, tmp, args.utts)
    cs.say(f"[multicard] {name}: {smi}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "torch_multicard.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
