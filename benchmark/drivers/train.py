"""VAW-GAN training: ``VAWGANTrainer.train`` fed batch by batch from the
port's epoch-shuffled ``BatchStream`` over a host frame table, as
``cli.train`` runs it by default (summaries every ``summary_freq`` steps,
no checkpoint inside the window).

End to end: ``train_step_ms``, the window's wall time over the steps
completed in it; the window ends at the first step boundary after
``--seconds`` (the feed refuses the next step's batches), after the card
has finished.  Set-up builds one trainer, loads the benchmark's weights
into it and drives it through its first steps with the window's own call,
arguments and feed, copying the state on the card at the feed's step
boundaries (no host sync); the check follows those steps with the plain
reference and compares every leaf's first Adam moment after step 1 and
every leaf's change after the first steps.
"""

from __future__ import annotations

import dataclasses
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from benchmark import generate
from benchmark.drivers.corpus import architecture
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train


class WindowClosed(Exception):
    """Raised by the feed at the first step boundary past the window."""


class Feed:
    """The batch iterator the trainer is fed: the port's stream, timed
    (span ``bench.input``) and asked at every step boundary whether to
    go on."""

    def __init__(self, stream, per_step: int):
        self.stream = stream
        self.per_step = per_step
        self.calls = 0
        self.input_s: list[float] = []
        self.boundary = lambda steps: None

    def __iter__(self):
        return self

    def __next__(self):
        if self.calls % self.per_step == 0:
            self.boundary(self.calls // self.per_step)
        t = time.perf_counter()
        with torch.profiler.record_function("bench.input"):
            b = next(self.stream)
        self.input_s.append(time.perf_counter() - t)
        self.calls += 1
        return b


def _named(gen, critic, what):
    out = {}
    for prefix, mod in (("gen.", gen), ("critic.", critic)):
        for name, p in mod.named_parameters():
            out[prefix + name] = what(p).detach().clone()
    return out


class Cell:
    def __init__(self, run):
        self.run = run
        self.snap: dict = {}

    def setup(self) -> None:
        from tpuvc_torch.data.dataset import FrameDataset
        from tpuvc_torch.data.normalizer import Tanhize
        from tpuvc_torch.train.trainer import VAWGANTrainer
        from tpuvc_torch.utils.config import Architecture
        run, t, cfg = self.run, self.run.traffic, self.run.config
        if run.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = cfg["train_cudnn_tf32"]
        arch = Architecture.from_json({**cfg["architecture"],
                                       "compute_dtype": cfg["train_dtype"]})
        self.x, self.y = generate.frame_table(run.seed, t, cfg, run.device)
        self.xmin, self.xmax = self.x.min(axis=0), self.x.max(axis=0)
        self.batch = arch.training.batch_size
        self.per_step = arch.training.n_unroll + 1
        self.batch_seed = generate.derive(run.seed, "batches") % 2**63
        self.train_seed = generate.derive(run.seed, "trainer") % 2**31
        ra = architecture(cfg, "train_dtype")
        self.gen_w = generate.weights(run.seed, "generator", {
            k: v.shape for k, v in ref_model.VAWGAN(ra).state_dict().items()},
            run.device)
        self.critic_w = generate.weights(run.seed, "critic", {
            k: v.shape for k, v in ref_model.Critic(ra).state_dict().items()},
            run.device)
        self.run_dir = tempfile.mkdtemp(prefix="bench-train-")
        self.trainer = VAWGANTrainer(arch, self.run_dir, seed=self.train_seed,
                                     use_tensorboard=t["tensorboard"],
                                     device=run.device)
        st = self.trainer.state
        st.gen.load_state_dict(self.gen_w)
        st.critic.load_state_dict(self.critic_w)
        ds = FrameDataset(x=self.x, y=self.y)
        stream = ds.batches(self.batch, seed=self.batch_seed,
                            normalizer=Tanhize(self.xmin, self.xmax))
        self.feed = Feed(stream, self.per_step)
        first = t["checked_steps"]

        def boundary(steps):
            if steps == 1:
                self.snap["moments"] = {
                    **_named(st.gen, st.critic, lambda p: self._moment(p))}
            if steps == first:
                self.snap["params"] = _named(st.gen, st.critic, lambda p: p)
                raise WindowClosed

        self.feed.boundary = boundary
        try:
            self.trainer.train(self.feed, total_steps=10**9)
        except WindowClosed:
            pass

    def _moment(self, p):
        st = self.trainer.state
        for opt in (st.opt_g, st.opt_d):
            if p in opt.state:
                return opt.state[p]["exp_avg"]
        return torch.zeros_like(p)

    def window(self, seconds: float) -> None:
        run, feed = self.run, self.feed
        feed.calls = 0
        feed.input_s = []
        t0 = time.perf_counter()

        def boundary(steps):
            run.counters.update(steps=steps,
                                window_s=time.perf_counter() - t0)
            run.spans["bench.input"] = feed.input_s
            run.boundary()
            if time.perf_counter() - t0 >= seconds:
                raise WindowClosed

        feed.boundary = boundary
        try:
            self.trainer.train(feed, total_steps=10**9)
        except WindowClosed:
            pass
        except Exception:              # a failed step ends the window
            traceback.print_exc(file=sys.stderr)
            run.failed += 1
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        t_last = time.perf_counter()
        steps = feed.calls // self.per_step
        run.attempted += steps + run.failed
        run.end_to_end["train_step_ms"] = 1e3 * (t_last - t0) / max(steps, 1)
        run.counters.update(steps=steps, window_s=t_last - t0)
        run.spans["bench.input"] = feed.input_s

    def release(self) -> None:
        self.trainer.close()
        del self.trainer, self.feed
        shutil.rmtree(self.run_dir, ignore_errors=True)
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, compute_dtype: str | None = None, rows: float = 1.0):
        """The reference trainer's first moments after step 1 and
        parameters after the checked steps; ``compute_dtype`` overrides
        the configuration's."""
        arch = architecture(self.run.config, "train_dtype")
        if compute_dtype is not None:
            arch = dataclasses.replace(arch, compute_dtype=compute_dtype)
        tr = ref_train.Trainer(arch, self.gen_w, self.critic_w,
                               self.run.device, rows=rows)
        batches = ref_train.Batches(self.x, self.y, self.batch,
                                    self.batch_seed, self.xmin, self.xmax)
        moments = None
        for s in range(self.run.traffic["checked_steps"]):
            noise = ref_train.step_noise(self.train_seed, s, arch, self.batch,
                                         self.run.device)
            tr.step([next(batches) for _ in range(self.per_step)], noise)
            if s == 0:
                moments = tr.first_moments()
        return moments, tr.params()

    def readings(self, moments, params, ref_out) -> dict:
        r_moments, r_params = ref_out
        norms = {k: float(torch.linalg.vector_norm(v.double()))
                 for k, v in r_moments.items()}
        med = float(np.median(list(norms.values())))
        keep = [k for k, n in norms.items() if n >= 1e-3 * med]
        start = {**{"gen." + k: v for k, v in self.gen_w.items()},
                 **{"critic." + k: v for k, v in self.critic_w.items()}}
        return {
            "moment_gap": ref_train.leaf_gaps(moments, r_moments, keep),
            "update_gap": ref_train.leaf_gaps(
                {k: params[k] - start[k] for k in keep},
                {k: r_params[k] - start[k] for k in keep}, keep)}

    def check(self) -> dict:
        got = self.readings(self.snap["moments"], self.snap["params"],
                            self.reference())
        return {k: (v, self.run.limits[k]) for k, v in got.items()}

    def control_readings(self, halves: bool = False) -> dict:
        """The compared numbers of the program, of the control (the
        reference in bf16, the step below the configuration's float32)
        and of the planted fault that keeps half of each batch."""
        ref_out = self.reference()
        out = {"program": self.readings(self.snap["moments"],
                                        self.snap["params"], ref_out)}
        for side, kw in (("control", {"compute_dtype": "bfloat16"}),
                         ("half_batch", {"rows": 0.5})):
            out[side] = self.readings(*self.reference(**kw), ref_out)
        return out
