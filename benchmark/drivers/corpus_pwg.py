"""Corpus conversion vocoded by Parallel WaveGAN: the corpus driver's
closed loop of ``Converter.convert_batch`` calls, with the converter
holding the configuration's vocoder (``vocoder`` block), which makes the
waveform from the converted features in place of WORLD's synthesis.

Set-up draws the vocoder's weights from the seed (``generate.weights``,
tag "vocoder") and takes the statistics that standardize its conditioning
(the published recipe's training statistics) from the analysed features
of the first ``STATS_UTTERANCES`` utterances of the pool, analysed by
the plain reference.

The check converts a seeded sample of the window's requests again with
the plain reference (``reference/pwg.py``: the same analysis and model,
the generator in float32 with TF32 off) and compares two things the
program produced: each utterance's waveform (``wave_err_db_*``), and the
conditioning the program fed its vocoder, over the utterance's frames in
the vocoder's standardized units (``aux_err_db_max``).  With random
weights the generator barely hears one of its 80 channels, so the
waveform alone would not show a wrong f0 transform; the conditioning
does.  The sample is drawn while the window runs (a seeded reservoir over
the completed requests), so only the sampled requests' conditioning is
held.  The control takes the model's and the generator's operands to fp8
e4m3 and the features through bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import generate
from benchmark.drivers import corpus
from benchmark.reference import convert as ref
from benchmark.reference import pwg as ref_pwg

STATS_UTTERANCES = 16


def vocoder_weights(run, config: dict) -> dict:
    """The generator's parameters, drawn from the seed."""
    shapes = {k: v.shape for k, v in ref_pwg.ParallelWaveGAN(ref_pwg.Spec(
        config["vocoder"])).named_parameters()}
    return generate.weights(run.seed, "vocoder", shapes, run.device)


def aux_stats(config: dict, pool: generate.CorpusTraffic, device) -> dict:
    """``aux_mean`` and ``aux_scale``: the mean and the standard deviation
    of each conditioning channel over the real frames of the pool's first
    utterances, analysed by the plain reference."""
    world = ref.World(**config["world"])
    waves = pool.waves[:STATS_UTTERANCES]
    t = max(len(x) for x in waves)
    x = torch.as_tensor(np.stack([np.pad(w, (0, t - len(w)))
                                  for w in waves]), device=device)
    with ref_pwg.strict_float32():
        c = ref_pwg.aux_features(*ref.world_features(x, world), world,
                                 ref_pwg.Spec(config["vocoder"]))
    frames = torch.cat([c[i, :, :len(w) // world.hop + 1]
                        for i, w in enumerate(waves)], dim=1)
    return {"aux_mean": frames.mean(dim=1),
            "aux_scale": torch.clamp(frames.std(dim=1), min=1e-3)}


def make_converter(run, state: dict, vocoder_state: dict, assets: dict,
                   transfer: str):
    """The corpus driver's ``Converter`` with the configuration's vocoder
    beside the model, in the serving compute type."""
    from tpuvc_torch.convert.pipeline import Converter
    from tpuvc_torch.models import pwg
    conv = corpus.make_converter(run, state, assets, transfer)
    vocoder = pwg.load_vocoder(pwg.PWGSpec.from_json(run.config["vocoder"]),
                               vocoder_state, run.device,
                               run.config["serve_dtype"])
    return Converter(conv.model, conv.assets, cfg=conv.cfg,
                     bucket_s=run.traffic["bucket_s"],
                     transfer_encoding=transfer, device=run.device,
                     vocoder=vocoder)


def aux_errors(got, want, lens, stats: dict, hop: int) -> list[float]:
    """Each utterance's conditioning error in dB: the energy of ``got -
    want`` over that of ``want`` less the mean, both in the vocoder's
    standardized units, over the utterance's frames but the last two."""
    mean, scale = stats["aux_mean"][:, None], stats["aux_scale"][:, None]
    out = []
    for i, n in enumerate(lens):
        f = max(1, n // hop - 1)
        d = ((got[i, :, :f] - want[i, :, :f]) / scale).double()
        r = ((want[i, :, :f] - mean) / scale).double()
        out.append(10.0 * float(torch.log10(torch.clamp(
            (d * d).sum(), min=1e-30) / torch.clamp((r * r).sum(),
                                                    min=1e-30))))
    return out


class Cell(corpus.Cell):
    def setup(self) -> None:
        run, t = self.run, self.run.traffic
        self.pool = generate.CorpusTraffic(run.seed, t, run.config,
                                           run.device)
        self.state = corpus.generator_weights(run, run.config)
        self.assets = generate.assets(run.seed, run.config)
        self.stats = aux_stats(run.config, self.pool, run.device)
        self.vocoder_state = {**vocoder_weights(run, run.config),
                              **self.stats}
        self.conv = make_converter(run, self.state, self.vocoder_state,
                                   self.assets, t["transfer"])
        # the conditioning each vocoder call of a request took
        self.fed: list[torch.Tensor] = []
        self.conv.vocoder.register_forward_pre_hook(
            lambda _m, args: self.fed.append(args[1]))
        self.kept: dict[int, torch.Tensor] = {}
        self.reservoir = np.random.default_rng(
            generate.derive(run.seed, "check"))
        self.served = None                  # window requests completed
        self.requests = self.pool.requests()
        for _ in range(t["warmup_requests"]):
            self._request(*next(self.requests)[1:])
        self.served = 0

    def _request(self, rows, trg, seeds):
        self.fed.clear()
        y = super()._request(rows, trg, seeds)
        if self.served is not None:
            self._keep(self.served, torch.cat(self.fed)[:len(rows)])
            self.served += 1
        return y

    def _keep(self, i: int, aux: torch.Tensor) -> None:
        """Reservoir sampling: after request i the kept requests are a
        uniform sample of the first i + 1."""
        k = self.run.traffic["check_requests"]
        if i < k:
            self.kept[i] = aux
            return
        j = int(self.reservoir.integers(0, i + 1))
        if j < k:
            del self.kept[sorted(self.kept)[j]]
            self.kept[i] = aux

    def sample(self) -> list:
        """The kept requests, with the conditioning each took."""
        return [(*self.done[i], self.kept[i]) for i in sorted(self.kept)
                if i < len(self.done)]

    def reference(self, degrade: str | None = None) -> ref_pwg.PWGReference:
        run, cfg = self.run, self.run.config
        return ref_pwg.PWGReference(
            corpus.architecture(cfg, "serve_dtype"), self.state, self.assets,
            cfg["world"], cfg["vocoder"], self.vocoder_state, run.device,
            bucket_s=run.traffic["bucket_s"],
            transfer=run.traffic["transfer"], degrade=degrade)

    def pwg_readings(self, reference, sample, control=None
                     ) -> tuple[list[float], list[float]]:
        """Each sampled utterance's waveform error and conditioning error
        against ``reference``: the program's, or with ``control`` that
        converter's."""
        hop = ref.World(**self.run.config["world"]).hop
        waves, auxs = [], []
        for rows, trg, seeds, y, aux in sample:
            args = self._args(rows, trg)
            r = reference.convert_batch(*args, seeds)
            want = reference.aux
            if control is not None:
                y = control.convert_batch(*args, seeds)
                aux = control.aux
            waves += [ref.error_db(g, w, 2 * hop) for g, w in zip(y, r)]
            auxs += aux_errors(aux, want, [len(x) for x in args[0]],
                               self.stats, hop)
        return waves, auxs

    def checks(self, waves, auxs) -> dict:
        lim = self.run.limits
        return {**corpus.wave_checks(waves, lim),
                "aux_err_db_max": (float(np.max(auxs)),
                                   lim["aux_err_db_max"])}

    def check(self) -> dict:
        run = self.run
        sample = self.sample()
        if not sample:
            return {}
        rec = run.roofline
        reference = self.reference()
        if rec is not None:
            with rec.recording():
                readings = self.pwg_readings(reference, sample)
            rec.requests += len(sample)
        else:
            readings = self.pwg_readings(reference, sample)
        return self.checks(*readings)

    def control_readings(self, halves: bool = False) -> dict:
        sample = self.sample()
        reference = self.reference()
        out = {}
        sides = ("program", "both") + (("model", "features") if halves
                                       else ())
        for side in sides:
            c = None if side == "program" else self.reference(side)
            readings = self.pwg_readings(reference, sample, c)
            out["control" if side == "both" else side] = {
                k: v for k, (v, _) in self.checks(*readings).items()}
        return out
