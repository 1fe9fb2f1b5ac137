"""The one generator of every cell's inputs, driven by a traffic file.

A traffic mix (``traffic/<name>.json``) holds parameters only: lengths,
batch, pool, chunking, arrivals.  Everything is drawn from ``--seed``
through named sub-seeds, so the same seed gives the same inputs and two
streams of draws never share a generator.  Sizes are stratified rather
than sampled: every seed gets the same set of utterance lengths (the
quantiles of the stated distribution) in another order, so a seed moves
which speaker says what, never how much work a run holds.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from benchmark import speech


def derive(seed: int, *tags) -> int:
    """A 63-bit sub-seed of ``seed`` for the purpose named by ``tags``."""
    words = [int(seed) % 2**32, int(seed) >> 32]
    for t in tags:
        words.append(zlib.crc32(t.encode()) if isinstance(t, str) else int(t))
    (s,) = np.random.SeedSequence(words).generate_state(1, np.uint64)
    return int(s) >> 1


def stratified_lengths(n: int, dist: dict, fs: int) -> np.ndarray:
    """``n`` lengths in samples, ascending: the (i + 1/2)/n quantiles of a
    log-normal of ``median`` and ``ln_sigma``, clipped to [min, max] s."""
    from statistics import NormalDist
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    sec = np.exp(math.log(dist["median"]) + dist["ln_sigma"] * z)
    sec = np.clip(sec, dist["min"], dist["max"])
    return np.round(sec * fs).astype(np.int64)


def speaker_table(config: dict) -> tuple[list[str], np.ndarray, np.ndarray,
                                         np.ndarray]:
    """Names, base f0 [S], formant pairs [S, 2] and tilts [S] of the
    configuration's speakers."""
    sp = config["speakers"]
    names = list(sp)
    f0 = np.array([sp[k]["f0"] for k in names], np.float64)
    fm = np.array([sp[k]["formants"] for k in names], np.float64)
    tilt = np.array([sp[k]["tilt_db"] for k in names], np.float64)
    return names, f0, fm, tilt


def utterances(seed: int, tag: str, config: dict, src: np.ndarray,
               lengths: np.ndarray, device) -> list[np.ndarray]:
    """One synthetic utterance per (speaker index, length), made on the
    device in one batch and brought to the host as float32 arrays."""
    _, f0, fm, tilt = speaker_table(config)
    g = torch.Generator(device=device).manual_seed(derive(seed, tag))
    fs = config["world"]["fs"]
    x = speech.synth_pool(g, torch.as_tensor(f0[src]),
                          torch.as_tensor(fm[src]),
                          torch.as_tensor(tilt[src]),
                          torch.as_tensor(lengths), fs).cpu().numpy()
    return [x[i, :lengths[i]].copy() for i in range(len(lengths))]


def assets(seed: int, config: dict) -> dict:
    """Per-speaker voiced log-f0 statistics and the Tanhize bounds of the
    normalised log envelope, drawn from the seed around each speaker's
    base f0 and a smooth spectral slope."""
    rng = np.random.default_rng(derive(seed, "assets"))
    names, f0, _, _ = speaker_table(config)
    half = config["world"]["fft_size"] // 2 + 1
    f0_mu = np.log(f0) + 0.02 * rng.standard_normal(len(names))
    f0_sigma = 0.08 + 0.04 * rng.random(len(names))
    k = np.arange(half) / (half - 1)
    wob = np.convolve(rng.standard_normal(half + 30), np.ones(31) / 31,
                      mode="valid")
    xmin = -9.5 - 1.5 * k + 0.6 * wob[:half]
    xmax = -0.8 - 2.5 * k + 0.3 * wob[::-1][:half]
    return {"speakers": names, "f0_mu": f0_mu.astype(np.float32),
            "f0_sigma": f0_sigma.astype(np.float32),
            "xmin": xmin.astype(np.float32), "xmax": xmax.astype(np.float32)}


# the truncated standard normal on [-2, 2] has std 0.87962566: Flax's
# lecun_normal divides by it so that the draw keeps std 1/sqrt(fan_in)
_TRUNC_STD = 0.87962566103423978


def weights(seed: int, tag: str, shapes: dict[str, torch.Size],
            device) -> dict[str, torch.Tensor]:
    """Float32 parameters for a state dict of ``shapes``, drawn on the
    device in two calls with Flax's initializers: LeCun-normal kernels
    truncated at two standard deviations, embedding tables of std
    1/sqrt(features), zero biases, unit LayerNorm scales."""
    g = torch.Generator(device=device).manual_seed(derive(seed, tag))
    total = sum(math.prod(s) for s in shapes.values())
    trunc = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(trunc, 0.0, 1.0, -2.0, 2.0, generator=g)
    normal = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        if name.endswith("bias"):
            t = torch.zeros(shape, device=device)
        elif "norm" in name:
            t = torch.ones(shape, device=device)
        elif name.endswith("embed"):
            t = normal[at:at + n].view(shape) / math.sqrt(shape[1])
        else:
            fan_in = n // shape[0]
            t = trunc[at:at + n].view(shape) * (
                1.0 / math.sqrt(fan_in) / _TRUNC_STD)
        out[name] = t.clone()
        at += n
    return out


class CorpusTraffic:
    """Closed-loop corpus requests over a pool of utterances.

    The pool holds ``pool`` utterances at the stratified lengths, each of
    a seeded source speaker.  Ranked by length, the pool deals into
    pool/batch groups, rank r to group r mod groups, so every request
    holds the same spread of lengths, every one the longest; a pass over
    the pool sends the groups in a seeded order, rows shuffled, each row
    with a seeded target speaker other than its source and a noise seed
    of its own."""

    def __init__(self, seed: int, traffic: dict, config: dict, device):
        self.seed = seed
        self.batch = traffic["utts_per_request"]
        fs = config["world"]["fs"]
        lengths = stratified_lengths(traffic["pool"], traffic["length_s"], fs)
        if traffic["pool"] % self.batch:
            raise ValueError("the pool must hold whole requests")
        self.n_speakers = len(config["speakers"])
        rng = np.random.default_rng(derive(seed, "corpus-pool"))
        self.src = rng.integers(0, self.n_speakers, len(lengths))
        self.lengths = lengths
        self.waves = utterances(seed, "corpus-speech", config, self.src,
                                lengths, device)
        self.groups = np.arange(len(lengths)).reshape(-1, len(lengths)
                                                      // self.batch).T
        self.noise_base = derive(seed, "corpus-noise") % 2**40
        self.fs = fs

    def requests(self):
        """Endless (k, pool rows [B], target ids [B], noise seeds [B])."""
        rng = np.random.default_rng(derive(self.seed, "corpus-requests"))
        k = 0
        while True:
            for grp in rng.permutation(len(self.groups)):
                rows = rng.permutation(self.groups[grp])
                trg = (self.src[rows] + rng.integers(
                    1, self.n_speakers, len(rows))) % self.n_speakers
                seeds = self.noise_base + k * self.batch + np.arange(
                    len(rows), dtype=np.int64)
                yield k, rows, trg, seeds
                k += 1


def frame_table(seed: int, traffic: dict, config: dict, device
                ) -> tuple[np.ndarray, np.ndarray]:
    """A training split's frame table, made on the device in a few large
    calls: ``speakers x utts_per_speaker`` utterances of ``utt_s``
    seconds at the configuration's frame rate, each frame a normalised
    log10 envelope [sp_dim] that is smooth across frequency (a cosine
    series with a speaker's own coefficients, an utterance's slow drift
    and a frame's jitter), in corpus order; and the speaker labels."""
    w = config["world"]
    half = w["fft_size"] // 2 + 1
    n_spk = len(config["speakers"])
    per_utt = int(traffic["utt_s"] * 1000.0 / w["frame_period_ms"]) + 1
    n_utt = n_spk * traffic["utts_per_speaker"]
    g = torch.Generator(device=device).manual_seed(derive(seed, "table"))
    n_basis = 12
    k = torch.arange(half, device=device, dtype=torch.float32) / (half - 1)
    basis = torch.cos(math.pi * torch.arange(n_basis, device=device)[:, None]
                      * k[None, :])                            # [J, half]
    scale = 1.0 / (1.0 + torch.arange(n_basis, device=device))
    spk = torch.randn((n_spk, n_basis), generator=g, device=device) * scale
    utt = 0.3 * torch.randn((n_utt, n_basis), generator=g,
                            device=device) * scale
    label = torch.arange(n_utt, device=device) // traffic["utts_per_speaker"]
    coef = (spk[label] + utt).repeat_interleave(per_utt, dim=0)
    coef += 0.1 * torch.randn(coef.shape, generator=g, device=device) * scale
    x = -3.5 - 2.0 * k[None, :] + coef @ basis                  # [F, half]
    return (x.cpu().numpy(),
            label.repeat_interleave(per_utt).to(torch.int32).cpu().numpy())


class LiveTraffic:
    """Open-loop live streams: each stream a seeded source speaker and a
    seeded target other than it, its audio a seeded sequence of that
    speaker's pool utterances with pauses between them, long enough for
    ``max_audio_s`` seconds of chunks."""

    def __init__(self, seed: int, traffic: dict, config: dict, device):
        fs = config["world"]["fs"]
        n_spk = len(config["speakers"])
        lengths = stratified_lengths(traffic["pool"], traffic["length_s"], fs)
        rng = np.random.default_rng(derive(seed, "live-pool"))
        pool_src = np.arange(len(lengths)) % n_spk
        rng.shuffle(pool_src)
        waves = utterances(seed, "live-speech", config, pool_src, lengths,
                           device)
        rng = np.random.default_rng(derive(seed, "live-streams"))
        n = traffic["streams"]
        self.src = rng.integers(0, n_spk, n)
        self.trg = (self.src + rng.integers(1, n_spk, n)) % n_spk
        need = int(traffic["max_audio_s"] * fs)
        lo, hi = traffic["pause_s"]
        self.audio = []
        for s in self.src:
            mine = np.flatnonzero(pool_src == s)
            parts, total = [], 0
            while total < need:
                for u in rng.permutation(mine):
                    pause = np.zeros(int(rng.uniform(lo, hi) * fs), np.float32)
                    parts += [waves[u], pause]
                    total += len(waves[u]) + len(pause)
            self.audio.append(np.concatenate(parts)[:need])
        # the streaming converter passes each window's seed as int32
        self.seed_base = derive(seed, "live-noise") % 2**30
