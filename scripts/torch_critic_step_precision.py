"""How closely float32 VAW-GAN critic gradients hold on the card and on the
CPU, against a float64 reference, on chip_smoke.py's phase-6 training data.

  python3 scripts/torch_critic_step_precision.py

Needs a CUDA card; imports no JAX.  For the full-width architecture
(configs/architecture-vawgan-vcc2016.json, batch 256) and two training
splits of make_vcc2016_corpus's first 10 speakers x 8 utterances of 1.5 s
(non-parallel, and parallel across speakers), it prints:

  - the first critic update's gradient, split into the Wasserstein term and
    the penalty term, on the card (float32) and on the CPU (float32),
    each as max |g - g64| / max |g64| per tensor against the CPU in float64;
  - one full VAW-GAN step (5 critic updates, 1 generator update) on the card
    and on the CPU: per tensor the largest parameter difference, in lr,
    among the elements whose |g| is at least 1% of the tensor's max in
    every update (chip_smoke.py:params_agree's "significant" elements).
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def batches(corpus: str, arch, parallel: bool):
    """The phase-6 corpus's n_unroll + 1 first training batches."""
    from tpuvc_torch.cli import analyze
    from tpuvc_torch.data import synthetic
    from tpuvc_torch.data.dataset import FrameDataset
    from tpuvc_torch.data.normalizer import Tanhize
    defs = dict(list(synthetic.VCC2016_SPEAKER_DEFS.items())[:10])
    synthetic.make_corpus(corpus, n_train=8, n_test=0, dur_s=1.5, seed=0,
                          speaker_defs=defs, parallel=parallel)
    analyze.main(["--corpus", corpus, "--splits", "train", "--quiet",
                  "--device", "cuda"])
    ds = FrameDataset.from_bin_dir(corpus)
    stream = ds.batches(arch.training.batch_size, seed=0,
                        normalizer=Tanhize.from_etc(os.path.join(corpus,
                                                                 "etc")))
    xs, ys = zip(*(next(stream) for _ in range(arch.training.n_unroll + 1)))
    return (torch.from_numpy(np.stack(xs[:-1])),
            torch.from_numpy(np.stack(ys[:-1])).long(),
            torch.from_numpy(xs[-1]), torch.from_numpy(ys[-1]).long())


def first_update_grads(arch, batch, noise, dev, dtype):
    """The first critic update's gradients, (Wasserstein term, penalty
    term), one float64 CPU tensor per parameter."""
    from tpuvc_torch.models import losses
    from tpuvc_torch.train import steps as steps_lib
    st = steps_lib.init_vawgan_state(arch, 0, dev)
    if dtype == torch.float64:
        for m in (st.gen, st.critic):
            m.double()
            m.dtype = dtype
    x, y = batch[0][0].to(dev, dtype), batch[1][0].to(dev)
    with torch.no_grad():
        xh = st.gen(x, y, noise.z_crit[0].to(dev, dtype))["xh"]
    params = list(st.critic.parameters())
    w = losses.wasserstein_distance(st.critic(x, y), st.critic(xh, y))
    gp = losses.gradient_penalty(st.critic, noise.gp[0].to(dev, dtype), x,
                                 xh, y)
    out = []
    for loss in (-w, arch.training.gp_lambda * gp):
        gs = torch.autograd.grad(loss, params, retain_graph=True,
                                 allow_unused=True)
        out.append([torch.zeros(p.shape, dtype=torch.float64) if g is None
                    else g.detach().double().cpu()
                    for p, g in zip(params, gs)])
    return out


def step_params(arch, batch, noise, dev):
    """Parameters and every update's gradients after one VAW-GAN step."""
    from tpuvc_torch.train import steps as steps_lib
    st = steps_lib.init_vawgan_state(arch, 0, dev)
    seen_g, seen_d = cs.record_grads(st.opt_g), cs.record_grads(st.opt_d)
    steps_lib.vawgan_step(st, *(v.to(dev) for v in batch),
                          steps_lib.VAWGANNoise(noise.z_crit.to(dev),
                                                noise.gp.to(dev),
                                                noise.z_gen.to(dev)))
    return {"critic": (dict(st.critic.named_parameters()),
                       cs.named_grads(st.critic, seen_d)),
            "gen": (dict(st.gen.named_parameters()),
                    cs.named_grads(st.gen, seen_g))}


def significant_err(got, ref, grads, lr) -> dict:
    out = {}
    for n, g in got.items():
        sig = torch.ones(g.shape, dtype=torch.bool)
        for u in grads[n]:
            u = u.cpu().abs()
            sig &= u >= 1e-2 * u.max()
        err = (g.detach().cpu() - ref[n].detach().cpu()).abs() / lr
        out[n] = float(err[sig].max()) if bool(sig.any()) else 0.0
    return out


def main() -> int:
    from tpuvc_torch.train import steps as steps_lib
    from tpuvc_torch.utils.config import Architecture
    cs.phase_device()
    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    arch = Architecture.load(os.path.join(cs.ROOT, cs.TRAIN_ARCH))
    names = list(dict(steps_lib.init_vawgan_state(
        arch, 0, cpu).critic.named_parameters()))
    os.makedirs(os.path.join(cs.ROOT, "build"), exist_ok=True)
    for parallel in (False, True):
        with tempfile.TemporaryDirectory(
                dir=os.path.join(cs.ROOT, "build")) as tmp:
            batch = batches(os.path.join(tmp, "corpus"), arch, parallel)
        noise = steps_lib.vawgan_noise(steps_lib.step_generator(0, 0, dev),
                                       arch.training.batch_size, arch)
        ref = first_update_grads(arch, batch, noise, cpu, torch.float64)
        for side, d in (("card", dev), ("cpu", cpu)):
            got = first_update_grads(arch, batch, noise, d, torch.float32)
            for term, g32, g64 in zip(("wasserstein", "penalty"), got, ref):
                rel = sorted(((float((a - b).abs().max())
                               / max(float(b.abs().max()), 1e-30), n)
                              for n, a, b in zip(names, g32, g64)),
                             reverse=True)
                print(f"parallel={parallel} first critic update, {term} "
                      f"term, {side} float32 vs CPU float64: max |g - g64| "
                      f"/ max |g64| " + ", ".join(f"{n} {r:.2e}"
                                                  for r, n in rel[:3]),
                      flush=True)
        card, host = (step_params(arch, batch, noise, d) for d in (dev, cpu))
        for part in ("critic", "gen"):
            err = significant_err(card[part][0], host[part][0],
                                  host[part][1], arch.training.lr)
            top = sorted(err.items(), key=lambda kv: -kv[1])[:3]
            print(f"parallel={parallel} one VAW-GAN step, card vs CPU, "
                  f"{part}: largest error on significant elements (lr) "
                  + ", ".join(f"{n} {v:.3e}" for n, v in top), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
