"""A dry run of the port's three distributed surfaces on a tiny model.

    python -m tpuvc_torch.parallel.dryrun [N] [--device cuda|cpu]
        [--backend nccl|gloo]

The port's counterpart of ``__graft_entry__.py:dryrun_multichip``.  On that
function's tiny VAW-GAN and inputs it runs:

1. one data-parallel VAW-GAN step over N ranks, each a process of its own
   (``launch_ranks``: the JAX side's ``COORDINATOR_ADDRESS`` /
   ``NUM_PROCESSES`` / ``PROCESS_ID`` on a free localhost port), its
   metrics finite, every rank's parameters equal, and equal to one process
   stepping on the whole batch (rtol 2e-5, atol 2e-6, TF32 off);
2. ``Converter.convert_batch`` of N utterances over a local mesh of N
   devices, finite and within waveform SNR >= 40 dB of the unsharded call
   (one row per device against a batch of N: on the card, cuDNN's and
   cuFFT's algorithms may change with the batch);
3. ``analyze_sharded`` of 1 s over that mesh against
   ``dsp.world.analyze`` (relative error < 1e-3 of each output's max).

On the CPU the mesh is N x ``cpu`` and the ranks use gloo; on the card it
is N cards and the ranks take card ``rank % count`` (NCCL by default, which
needs a card per rank; ``--backend gloo`` runs several ranks on one card).

``launch_ranks`` and ``step_worker`` (``--step SPEC``, one rank of a
data-parallel step described by a saved spec) also serve the tests and
``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port of localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(args: list[str], n: int, env: dict | None = None,
                 timeout: float = 300.0) -> list[str]:
    """Run ``python ARGS`` as ranks 0..n-1 of one world, all started
    together (the JAX side's environment names, a free localhost port, the
    repository on ``PYTHONPATH``); return each rank's output.  Every rank
    must exit with 0 within ``timeout`` seconds: as soon as one fails, or
    at the deadline, every process still running is killed and
    RuntimeError shows the ranks' outputs."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        try:
            for rank in range(n):
                e = dict(os.environ)
                e["PYTHONPATH"] = (_ROOT + os.pathsep
                                   + e.get("PYTHONPATH", ""))
                e.update({"COORDINATOR_ADDRESS": f"localhost:{port}",
                          "NUM_PROCESSES": str(n), "PROCESS_ID": str(rank),
                          "LOCAL_RANK": str(rank)})
                e.update(env or {})
                logs.append(open(os.path.join(tmp, f"{rank}.log"), "w+"))
                procs.append(subprocess.Popen(
                    [sys.executable, *args], env=e, stdout=logs[-1],
                    stderr=subprocess.STDOUT, text=True))
            deadline = time.monotonic() + timeout
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(
            f"ranks {failed} of {n} failed or passed the {timeout:g} s "
            "limit:\n" + "\n".join(f"--- rank {r}:\n{o[-3000:]}"
                                   for r, o in enumerate(outs)))
    return outs


@contextlib.contextmanager
def strict_float32():
    """cuDNN's and cuBLAS's TF32 off inside the block (float32 throughout,
    so that two runs of one step compare at float32's tolerance)."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def make_state(arch, params: dict | None, seed: int, device):
    """A training state of ``arch`` on ``device``: holding ``params``
    (``{"gen", "critic"}`` or ``{"model"}``) when given, else the seeded
    init of ``seed``."""
    from tpuvc_torch.train import steps
    if arch.model == "VAWGAN":
        if params is None:
            return steps.init_vawgan_state(arch, seed, device)
        return steps.vawgan_state(arch, params["gen"], params["critic"],
                                  device)
    if params is None:
        return steps.init_vae_state(arch, seed, device)
    return steps.vae_state(arch, params["model"], device)


def take_step(state, batch: dict, noise, mesh=None) -> dict:
    """One training step of ``state`` on this process's rows of the global
    ``batch`` (``x_crit``, ``y_crit``, ``x_gen``, ``y_gen`` for a VAW-GAN
    state, ``x``, ``y`` for a VAE one; host or device tensors) and of the
    global ``noise`` (a ``VAWGANNoise``, or the VAE's eps); on a
    process-group ``mesh`` the gradients are the world's mean.  Returns the
    metrics of these rows as device tensors."""
    from tpuvc_torch.parallel.mesh import local_rows
    from tpuvc_torch.train import steps
    group = None if mesh is None else mesh.group
    if "x_gen" in batch:
        dev = next(state.gen.parameters()).device
        mine = local_rows(mesh, batch["x_gen"].shape[0])
        put = lambda t: t.to(dev)  # noqa: E731
        return steps.vawgan_step(
            state, put(batch["x_crit"][:, mine]),
            put(batch["y_crit"][:, mine]).long(), put(batch["x_gen"][mine]),
            put(batch["y_gen"][mine]).long(),
            steps.VAWGANNoise(*(put(t) for t in (
                noise.z_crit, noise.gp, noise.z_gen))).rows(mine), group)
    dev = next(state.model.parameters()).device
    mine = local_rows(mesh, batch["x"].shape[0])
    return steps.vae_step(state, batch["x"][mine].to(dev),
                          batch["y"][mine].to(dev).long(),
                          noise[mine].to(dev), group)


def step_params(state) -> dict:
    """A copy of the state's modules' parameters, on the host."""
    mods = ({"gen": state.gen, "critic": state.critic}
            if hasattr(state, "critic") else {"model": state.model})
    return {k: {n: p.detach().to("cpu", copy=True)
                for n, p in m.named_parameters()}
            for k, m in mods.items()}


def step_worker(spec_path: str) -> None:
    """One rank of a data-parallel step: joins the world the environment
    describes, takes the step the spec (``torch.save``'d by the caller)
    describes on its rows, and writes ``{out}.{rank}.pt``: the world's mean
    metrics, its parameters, its rank and device; with ``timed_steps``
    k > 0, then k more steps on the same rows, timed by the host clock
    around synchronised work (``step_ms``, ms per step).  Spec keys:
    ``arch`` (``Architecture.to_json()``), ``params`` (or None: the seeded
    init of ``seed``), ``batch``, ``noise``, ``device`` ("cuda" or "cpu"),
    ``backend``, ``out``, ``timed_steps`` (optional)."""
    from tpuvc_torch.parallel import distributed
    from tpuvc_torch.train.steps import all_reduce_mean
    from tpuvc_torch.utils.config import Architecture
    spec = torch.load(spec_path, weights_only=False)
    distributed.ensure_initialized(spec["backend"])
    mesh = distributed.global_mesh(spec["device"])
    arch = Architecture.from_json(spec["arch"])
    with strict_float32():
        state = make_state(arch, spec["params"], spec["seed"],
                           mesh.devices[0])
        m = take_step(state, spec["batch"], spec["noise"], mesh)
        vals = all_reduce_mean([v.reshape(1).float() for v in m.values()],
                               mesh.group)
        rec = {"metrics": {k: float(v) for k, v in zip(m, vals)},
               "params": step_params(state), "rank": mesh.rank,
               "world": mesh.size, "device": str(mesh.devices[0])}
        if spec.get("timed_steps"):
            rec["step_ms"] = _timed(
                lambda: take_step(state, spec["batch"], spec["noise"], mesh),
                mesh.devices[0], spec["timed_steps"], mesh.group)
    torch.save(rec, f"{spec['out']}.{mesh.rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _timed(fn, device, n: int, group=None) -> float:
    """ms per call of ``fn`` over ``n`` calls, host clock around
    synchronised work (the whole world starts together)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if group is not None:
            torch.distributed.barrier(group)

    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / n


def run_dp_step(spec: dict, n: int, workdir: str, env: dict | None = None,
                timeout: float = 300.0) -> list[dict]:
    """Save ``spec`` under ``workdir``, run ``step_worker`` as ``n`` ranks
    (``launch_ranks``) and return each rank's record, in rank order."""
    path = os.path.join(workdir, "dp_step_spec.pt")
    out = os.path.join(workdir, "dp_step")
    torch.save({**spec, "out": out}, path)
    launch_ranks(["-m", "tpuvc_torch.parallel.dryrun", "--step", path], n,
                 env, timeout)
    return [torch.load(f"{out}.{r}.pt", weights_only=False)
            for r in range(n)]


def _close(name: str, got: torch.Tensor, ref: torch.Tensor,
           rtol: float, atol: float) -> None:
    if not torch.allclose(got, ref, rtol=rtol, atol=atol):
        err = (got - ref).abs().max().item()
        raise AssertionError(f"{name}: max error {err:.3e} beyond rtol "
                             f"{rtol:g} / atol {atol:g}")


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str | None = None) -> None:
    """The three distributed surfaces on the JAX dry run's tiny model; any
    disagreement raises."""
    from tpuvc_torch.convert.pipeline import Converter, ConverterAssets
    from tpuvc_torch.dsp.constants import DEFAULT_WORLD
    from tpuvc_torch.dsp.world import analyze
    from tpuvc_torch.models.params import load_model
    from tpuvc_torch.parallel import mesh as mesh_lib
    from tpuvc_torch.parallel.frame_sharding import analyze_sharded
    from tpuvc_torch.train import steps
    from tpuvc_torch.utils.config import (Architecture, NetSpec,
                                          TrainConfig)
    from tpuvc_torch.utils.device import resolve

    dev = resolve(device)
    arch = Architecture(
        z_dim=16, y_dim=4, y_emb_dim=8,
        encoder=NetSpec((7, 7), (3, 3), (8, 16)),
        generator=NetSpec((7, 7, 7), (3, 3, 3), (16, 8, 1)),
        discriminator=NetSpec((7, 7), (3, 3), (8, 16)),
        training=TrainConfig(batch_size=2 * n_devices, n_unroll=2, lr=1e-3))
    b, nu = arch.training.batch_size, arch.training.n_unroll
    rng = np.random.default_rng(0)
    batch = {
        "x_crit": torch.from_numpy(rng.standard_normal(
            (nu, b, arch.x_dim)).astype(np.float32)),
        "y_crit": torch.from_numpy(rng.integers(0, arch.y_dim, (nu, b))),
        "x_gen": torch.from_numpy(rng.standard_normal(
            (b, arch.x_dim)).astype(np.float32)),
        "y_gen": torch.from_numpy(rng.integers(0, arch.y_dim, b))}
    noise = steps.vawgan_noise(steps.step_generator(1, 0, "cpu"), b, arch)

    # 1. one data-parallel step over n ranks against one process
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_dp_step(
            {"arch": arch.to_json(), "params": None, "seed": 0,
             "batch": batch, "noise": noise, "device": dev.type,
             "backend": backend or ("gloo" if dev.type == "cpu" else None)},
            n_devices, tmp)
    with strict_float32():
        ref = make_state(arch, None, 0, dev)
        take_step(ref, batch, noise)
    want = step_params(ref)
    for r in ranks:
        if not all(np.isfinite(v) for v in r["metrics"].values()):
            raise AssertionError(f"rank {r['rank']}: metrics {r['metrics']}")
        for mod, ps in r["params"].items():
            for n, p in ps.items():
                if not torch.equal(p, ranks[0]["params"][mod][n]):
                    raise AssertionError(f"ranks 0 and {r['rank']} differ "
                                         f"in {mod}.{n}")
                _close(f"{mod}.{n}", p, want[mod][n], 2e-5, 2e-6)
    print(f"[dryrun_multichip] ok on {n_devices} ranks "
          f"({', '.join(r['device'] for r in ranks)}): "
          f"{ {k: round(v, 3) for k, v in ranks[0]['metrics'].items()} }",
          flush=True)

    # 2. serving over a local mesh
    mesh = (mesh_lib.make_mesh(devices=[dev] * n_devices)
            if dev.type == "cpu" else mesh_lib.make_mesh(n_devices))
    cfg = DEFAULT_WORLD
    assets = ConverterAssets(
        xmin=np.full(cfg.sp_dim, -10.0, np.float32),
        xmax=np.full(cfg.sp_dim, 1.0, np.float32),
        f0_mu=np.full(arch.y_dim, 5.0, np.float32),
        f0_sigma=np.ones(arch.y_dim, np.float32),
        speakers=[f"S{i}" for i in range(arch.y_dim)])
    conv = Converter(load_model(arch, ref.gen.state_dict(), mesh.devices[0]),
                     assets, cfg=cfg, bucket_s=0.2, device=mesh.devices[0])
    t = np.arange(int(0.2 * cfg.fs)) / cfg.fs
    xs = [(0.3 * np.sin(2 * np.pi * (120.0 + 15 * i) * t)).astype(np.float32)
          for i in range(n_devices)]
    trgs = [f"S{1 + i % (arch.y_dim - 1)}" for i in range(n_devices)]
    ys = conv.convert_batch(xs, ["S0"] * n_devices, trgs, seed=0, mesh=mesh)
    ys_ref = conv.convert_batch(xs, ["S0"] * n_devices, trgs, seed=0)
    if len(ys) != n_devices or not all(np.isfinite(y).all() for y in ys):
        raise AssertionError("sharded convert: missing or non-finite output")
    for y, y_ref in zip(ys, ys_ref):
        snr = 10 * np.log10(np.sum(y_ref.astype(np.float64) ** 2) / max(
            np.sum((y - y_ref).astype(np.float64) ** 2), 1e-30))
        if not snr >= 40.0:
            raise AssertionError(f"sharded convert: waveform SNR {snr:.1f} "
                                 "dB against the unsharded call")
    print(f"[dryrun_multichip] sharded convert ok: {len(ys)} utterances "
          f"over {mesh.size} devices", flush=True)

    # 3. frame-sharded analysis of one long utterance
    t_long = np.arange(int(1.0 * cfg.fs)) / cfg.fs
    x_long = (0.3 * np.sin(2 * np.pi * 150.0 * t_long)
              + 0.1 * np.sin(2 * np.pi * 300.0 * t_long)).astype(np.float32)
    got = analyze_sharded(x_long, mesh, cfg)
    ref_f = analyze(x_long, cfg, device=mesh.devices[0])
    for name, a, r in zip(("f0", "sp", "ap"), got, ref_f):
        if a.shape != r.shape or not torch.isfinite(a).all():
            raise AssertionError(f"frame-sharded {name}: shape "
                                 f"{tuple(a.shape)} vs {tuple(r.shape)}, "
                                 "or non-finite")
        rel = ((a - r).abs().max() / r.abs().max().clamp(min=1e-12)).item()
        if not rel < 1e-3:
            raise AssertionError(f"frame-sharded {name} deviates: rel "
                                 f"{rel:.2e}")
    print(f"[dryrun_multichip] frame-sharded analysis ok: "
          f"{got.sp.shape[0]} frames over {mesh.size} devices", flush=True)


def main(argv: list[str] | None = None) -> None:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_devices", nargs="?", type=int, default=None,
                   help="ranks and mesh devices (default: every card)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    p.add_argument("--step", default=None, metavar="SPEC",
                   help="run one rank of a data-parallel step (internal)")
    args = p.parse_args(argv)
    if args.step:
        step_worker(args.step)
        return
    n = args.n_devices or (torch.cuda.device_count()
                           if args.device != "cpu" else 2)
    dryrun_multichip(n, args.device, args.backend)


if __name__ == "__main__":
    main()
