"""Corpus conversion: one client sends ``Converter.convert_batch`` calls
back to back (a closed loop), each request a batch of utterances.

End to end: ``audio_s_per_s``, the real (unpadded) input audio of every
request completed in the window over the time from the window's start
to the last completion; the window finishes the request it is in.  The
check converts a seeded sample of the completed requests again with the
plain reference and compares every utterance's waveform.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback

import numpy as np
import torch

from benchmark import generate
from benchmark.reference import arch as ref_arch
from benchmark.reference import convert as ref
from benchmark.reference import model as ref_model


def architecture(config: dict, dtype_key: str) -> ref_arch.Architecture:
    """The configuration's architecture with the compute type of
    ``dtype_key`` ("serve_dtype" or "train_dtype")."""
    a = ref_arch.Architecture.from_json(config["architecture"])
    return dataclasses.replace(a, compute_dtype=config[dtype_key])


def generator_weights(run, config: dict) -> dict:
    shapes = {k: v.shape for k, v in ref_model.VAWGAN(
        architecture(config, "serve_dtype")).state_dict().items()}
    return generate.weights(run.seed, "generator", shapes, run.device)


def make_converter(run, state: dict, assets: dict, transfer: str):
    """The port's ``Converter`` holding ``state``, as ``cli.convert``
    builds one, with the configuration's compute type and analysis."""
    from tpuvc_torch.convert.pipeline import Converter, ConverterAssets
    from tpuvc_torch.dsp.constants import WorldConfig
    from tpuvc_torch.models.params import load_model
    from tpuvc_torch.utils.config import Architecture
    cfg = run.config
    arch = Architecture.from_json({**cfg["architecture"],
                                   "compute_dtype": cfg["serve_dtype"]})
    model = load_model(arch, state, run.device)
    return Converter(model, ConverterAssets(**assets),
                     cfg=WorldConfig(**cfg["world"]),
                     bucket_s=run.traffic["bucket_s"],
                     transfer_encoding=transfer, device=run.device)


def make_reference(run, state: dict, assets: dict, transfer: str,
                   degrade: str | None = None) -> ref.Reference:
    cfg = run.config
    return ref.Reference(architecture(cfg, "serve_dtype"), state, assets,
                         cfg["world"], run.device,
                         bucket_s=run.traffic["bucket_s"], transfer=transfer,
                         degrade=degrade)


def wave_checks(errs: list[float], limits: dict) -> dict:
    """The compared numbers (the worst and the median utterance's error
    in dB), each with its limit."""
    return {"wave_err_db_max": (float(np.max(errs)),
                                limits["wave_err_db_max"]),
            "wave_err_db_median": (float(np.median(errs)),
                                   limits["wave_err_db_median"])}


class Cell:
    def __init__(self, run):
        self.run = run
        self.done: list = []

    def setup(self) -> None:
        run, t = self.run, self.run.traffic
        self.state = generator_weights(run, run.config)
        self.assets = generate.assets(run.seed, run.config)
        self.conv = make_converter(run, self.state, self.assets,
                                   t["transfer"])
        self.pool = generate.CorpusTraffic(run.seed, t, run.config,
                                           run.device)
        self.requests = self.pool.requests()
        for _ in range(t["warmup_requests"]):
            self._request(*next(self.requests)[1:])

    def _args(self, rows, trg):
        names = self.assets["speakers"]
        return ([self.pool.waves[i] for i in rows],
                [names[s] for s in self.pool.src[rows]],
                [names[s] for s in trg])

    def _request(self, rows, trg, seeds):
        xs, srcs, trgs = self._args(rows, trg)
        return self.conv.convert_batch(xs, srcs, trgs, seed=seeds)

    def window(self, seconds: float) -> None:
        run = self.run
        fs, hop = self.pool.fs, ref.World(**run.config["world"]).hop
        audio = frames = 0.0
        t0 = time.perf_counter()
        while True:
            k, rows, trg, seeds = next(self.requests)
            run.attempted += 1
            with torch.profiler.record_function("bench.request"):
                try:
                    y = self._request(rows, trg, seeds)
                except Exception:          # a failed request is counted
                    traceback.print_exc(file=sys.stderr)
                    run.failed += 1
                    y = None
            t_last = time.perf_counter()
            if y is not None:
                self.done.append((rows, trg, seeds, y))
                lens = self.pool.lengths[rows]
                audio += float(lens.sum()) / fs
                frames += float((lens // hop + 1).sum())
            run.counters.update(requests=len(self.done), audio_s=audio,
                                frames=frames, window_s=t_last - t0)
            run.boundary()
            if t_last - t0 >= seconds:
                break
        run.end_to_end["audio_s_per_s"] = audio / (t_last - t0)

    def release(self) -> None:
        del self.conv
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """The seeded sample of completed requests that the check
        converts again."""
        n = min(self.run.traffic["check_requests"], len(self.done))
        rng = np.random.default_rng(generate.derive(self.run.seed, "check"))
        return [self.done[i] for i in sorted(rng.choice(
            len(self.done), size=n, replace=False))]

    def readings(self, reference: ref.Reference, sample,
                 control: ref.Reference | None = None) -> list[float]:
        """Each sampled utterance's error in dB against ``reference``: the
        program's output, or with ``control`` that converter's."""
        skip = 2 * ref.World(**self.run.config["world"]).hop
        errs = []
        for rows, trg, seeds, y in sample:
            args = self._args(rows, trg)
            r = reference.convert_batch(*args, seeds)
            if control is not None:
                y = control.convert_batch(*args, seeds)
            errs += [ref.error_db(g, want, skip) for g, want in zip(y, r)]
        return errs

    def check(self) -> dict:
        run = self.run
        sample = self.sample()
        if not sample:
            return {}
        reference = make_reference(run, self.state, self.assets,
                                   run.traffic["transfer"])
        rec = run.roofline
        if rec is not None:
            with rec.recording():
                errs = self.readings(reference, sample)
            rec.requests += len(sample)
        else:
            errs = self.readings(reference, sample)
        return wave_checks(errs, run.limits)

    def control_readings(self, halves: bool = False) -> dict:
        """The compared numbers of the program and of the control (the
        reference every stage one precision step lower) on the same
        sample; with ``halves`` also of each half of the control (the
        model in fp8, the features through bf16)."""
        run = self.run
        sample = self.sample()
        transfer = run.traffic["transfer"]
        reference = make_reference(run, self.state, self.assets, transfer)
        out = {}
        sides = ("program", "both") + (("model", "features") if halves
                                       else ())
        for side in sides:
            c = (None if side == "program" else make_reference(
                run, self.state, self.assets, transfer, degrade=side))
            errs = self.readings(reference, sample, c)
            out["control" if side == "both" else side] = {
                k: v for k, (v, _) in wave_checks(errs, run.limits).items()}
        return out
