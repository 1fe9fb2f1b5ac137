"""Synthetic mini-corpus generator (SURVEY.md SS4 item 3).

Builds a VCC2016-layout corpus of artificial 'speakers' — each with a
distinct f0 range and formant-like spectral envelope — so the full
analyze -> train -> convert loop runs CPU-only in tests and demos
(BASELINE config 1 is required to be CPU-runnable).

The port's own copy of ``tpuvc/data/synthetic.py``, through the port's
``io/wav.py`` and ``io/corpus.py``: the same seed writes the same bytes.
"""

from __future__ import annotations

import os

import numpy as np

from tpuvc_torch.io import corpus as corpus_io
from tpuvc_torch.io.wav import write_wav

# (base f0 Hz, formant center Hz pair, tilt dB/oct)
SPEAKER_DEFS = {
    "SA": (120.0, (500.0, 1500.0), -4.0),
    "SB": (200.0, (700.0, 2200.0), -6.0),
    "SC": (150.0, (600.0, 1800.0), -5.0),
    "SD": (260.0, (800.0, 2600.0), -7.0),
}

# VCC2016-shaped 10-speaker set (reference etc/speakers.tsv order,
# SURVEY.md SS2.1): 'F' speakers get higher base f0 ranges, 'M' lower;
# formants/tilt vary per speaker so conversion has real envelope targets.
VCC2016_SPEAKER_DEFS = {
    "SF1": (215.0, (620.0, 2100.0), -6.0),
    "SF2": (190.0, (700.0, 2300.0), -5.0),
    "SF3": (235.0, (560.0, 1950.0), -7.0),
    "SM1": (115.0, (480.0, 1500.0), -4.0),
    "SM2": (135.0, (520.0, 1650.0), -5.0),
    "TF1": (205.0, (660.0, 2200.0), -6.5),
    "TF2": (225.0, (590.0, 2000.0), -5.5),
    "TM1": (105.0, (460.0, 1400.0), -4.5),
    "TM2": (125.0, (540.0, 1700.0), -4.0),
    "TM3": (145.0, (500.0, 1550.0), -5.5),
}


def synth_utterance(rng: np.random.Generator, f0_base: float,
                    formants: tuple[float, float], tilt_db: float,
                    fs: int = 16000, dur_s: float = 0.8,
                    phase_rng: np.random.Generator | None = None
                    ) -> np.ndarray:
    """A vowel-like utterance: vibrato f0, formant envelope, breath noise.

    ``phase_rng`` (default: ``rng``) supplies the per-harmonic phase
    draws, whose COUNT depends on the speaker's f0 (n_harm = 6000/f0) —
    splitting them off lets parallel-corpus mode share ``rng`` (the
    content draws) across speakers without the harmonic loop
    desynchronizing the sequence (see make_corpus ``parallel``)."""
    if phase_rng is None:
        phase_rng = rng
    n = int(fs * dur_s)
    t = np.arange(n) / fs
    f0 = f0_base * (1.0 + 0.03 * np.sin(2 * np.pi * 2.5 * t)
                    + 0.02 * rng.standard_normal() )
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = np.zeros(n)
    n_harm = int(6000 / f0_base)
    for h in range(1, n_harm + 1):
        fh = h * f0_base
        # formant gains: two resonances + spectral tilt
        g = sum(1.0 / (1.0 + ((fh - fc) / 300.0) ** 2) for fc in formants)
        g = (0.2 + g) * 10.0 ** (tilt_db * np.log2(max(fh / f0_base, 1.0))
                                 / 20.0)
        x += g / h ** 0.3 * np.sin(h * phase
                                   + phase_rng.uniform(0, 2 * np.pi))
    x += 0.01 * rng.standard_normal(n)
    # fade edges to avoid clicks
    ramp = np.minimum(np.arange(n) / (0.02 * fs), 1.0)
    x *= ramp * ramp[::-1]
    return (0.4 * x / np.max(np.abs(x))).astype(np.float64)


def synth_hard_utterance(rng: np.random.Generator, f0_base: float,
                         formants: tuple[float, float], tilt_db: float,
                         fs: int = 16000, dur_s: float = 1.5,
                         phase_rng: np.random.Generator | None = None
                         ) -> np.ndarray:
    """An ADVERSARIAL utterance: syllable train with stop bursts, formant
    glides, f0 jitter + amplitude shimmer, and variable speaking rate.

    VERDICT r4 missing #2: the vowel-like corpus (synth_utterance) is
    stationary harmonic stacks — no plosives, no coarticulation, no
    silence/speech transitions at realistic rates — so every quality
    number carried an optimism bias.  This generator keeps the same
    speaker identity knobs (f0 base, formant pair, tilt) but arranges
    them as speech does:

      - syllables of 60-220 ms voiced nuclei separated by 20-80 ms
        closures (silence + noise floor), rate scaled per utterance by
        a 0.7-1.4x speaking-rate factor;
      - ~half the syllables onset with a plosive-like 6-12 ms broadband
        burst after the closure (stop consonants);
      - each nucleus GLIDES its formants from a random onset point to
        the speaker's targets (diphthong/coarticulation), recomputing
        the harmonic gains per sample;
      - f0 carries a declination + random-walk contour with ~0.8%
        per-period jitter; the amplitude carries ~6% shimmer.

    ``phase_rng`` (default: ``rng``): see synth_utterance — the
    harmonic-phase draw count depends on the speaker's f0_base, so
    parallel-corpus mode routes phases to a separate stream to keep the
    shared content draws (timing, rate, contours) aligned across
    speakers.
    """
    if phase_rng is None:
        phase_rng = rng
    n = int(fs * dur_s)
    x = np.zeros(n)
    rate = rng.uniform(0.7, 1.4)                 # speaking-rate factor
    pos = int(rng.uniform(0.0, 0.04) * fs)
    f1b, f2b = formants
    while pos < n - int(0.05 * fs):
        # closure (silence) then optional stop burst
        closure = int(rng.uniform(0.02, 0.08) * rate * fs)
        pos += closure
        if rng.uniform() < 0.5 and pos < n - int(0.02 * fs):
            blen = int(rng.uniform(0.006, 0.012) * fs)
            blen = min(blen, n - pos)
            burst = rng.standard_normal(blen)
            burst *= np.exp(-np.arange(blen) / (0.003 * fs))   # sharp decay
            x[pos:pos + blen] += 0.35 * burst
            pos += blen + int(rng.uniform(0.003, 0.010) * fs)
        # voiced nucleus with formant glide + jitter/shimmer
        nlen = int(rng.uniform(0.06, 0.22) * rate * fs)
        nlen = min(nlen, n - pos)
        if nlen < int(0.03 * fs):
            break
        t = np.arange(nlen) / fs
        # f0 contour: declination + slow random walk + fast jitter
        walk = np.cumsum(rng.standard_normal(nlen)) / fs
        jit = rng.standard_normal(nlen)
        k = max(int(0.004 * fs), 1)              # ~1 pitch period smoothing
        jit = np.convolve(jit, np.ones(k) / k, mode="same")
        f0 = f0_base * (1.0 + rng.uniform(-0.08, 0.12)) \
            * (1.0 - 0.06 * t / max(t[-1], 1e-6)) \
            * (1.0 + 0.5 * walk) * (1.0 + 0.008 * jit)
        f0 = np.clip(f0, 0.55 * f0_base, 1.8 * f0_base)
        phase = 2 * np.pi * np.cumsum(f0) / fs
        # formant glide: onset point -> speaker target over the nucleus
        g1 = np.linspace(f1b * rng.uniform(0.6, 1.5), f1b, nlen)
        g2 = np.linspace(f2b * rng.uniform(0.7, 1.4), f2b, nlen)
        seg = np.zeros(nlen)
        n_harm = int(6000 / f0_base)
        for h in range(1, n_harm + 1):
            fh = h * f0                           # [nlen] time-varying
            g = (1.0 / (1.0 + ((fh - g1) / 300.0) ** 2)
                 + 1.0 / (1.0 + ((fh - g2) / 300.0) ** 2))
            g = (0.2 + g) * 10.0 ** (
                tilt_db * np.log2(np.maximum(fh / f0_base, 1.0)) / 20.0)
            seg += np.where(fh < 0.45 * fs,
                            g / h ** 0.3
                            * np.sin(h * phase
                                     + phase_rng.uniform(0, 2 * np.pi)),
                            0.0)
        # shimmer: slow multiplicative amplitude noise
        sh = rng.standard_normal(nlen)
        ks = max(int(0.01 * fs), 1)
        sh = np.convolve(sh, np.ones(ks) / ks, mode="same")
        seg *= 1.0 + 0.06 * sh / max(np.std(sh), 1e-9)
        # 8 ms onset/offset ramps (release/decay, avoids clicks)
        r = min(int(0.008 * fs), nlen // 2)
        env = np.ones(nlen)
        env[:r] = np.linspace(0, 1, r)
        env[-r:] = np.linspace(1, 0, r)
        x[pos:pos + nlen] += seg * env
        pos += nlen
    x += 0.008 * rng.standard_normal(n)          # breath-noise floor
    peak = np.max(np.abs(x))
    return (0.4 * x / max(peak, 1e-9)).astype(np.float64)


def make_corpus(root: str, n_train: int = 6, n_test: int = 2,
                fs: int = 16000, dur_s: float = 0.8, seed: int = 0,
                speaker_defs: dict | None = None,
                style: str = "vowel", parallel: bool = False) -> None:
    """``parallel=True`` makes utterance i a PARALLEL recording across
    speakers: its content draws (syllable timing, speaking rate, f0
    contour shape, glide onsets) come from a per-(split, i) generator
    shared by every speaker, so only the speaker identity knobs differ
    — the precondition for a framewise conversion-MCD "vs the target's
    parallel recording" to be meaningful.  Without it the hard style's
    variable timing makes framewise MCD content-mismatch-dominated
    (measured: ~36 dB framewise / 13.8 DTW on non-parallel hard
    recordings vs ~5 dB on the stationary vowel style, 2026-08-19).
    Default False preserves the draw sequence every earlier round's
    corpus and published number came from."""
    rng = np.random.default_rng(seed)
    defs = speaker_defs if speaker_defs is not None else SPEAKER_DEFS
    synth = {"vowel": synth_utterance, "hard": synth_hard_utterance}[style]
    speakers = list(defs)
    corpus_io.write_speakers(os.path.join(root, "etc"), speakers)
    for si, (split, count) in enumerate(
            ((corpus_io.TRAIN_SPLIT, n_train),
             (corpus_io.TEST_SPLIT, n_test))):
        for spk in speakers:
            f0b, formants, tilt = defs[spk]
            d = os.path.join(root, "wav", split, spk)
            os.makedirs(d, exist_ok=True)
            for i in range(count):
                if parallel:
                    content = np.random.default_rng((seed, si, i))
                    x = synth(content, f0b, formants, tilt, fs, dur_s,
                              phase_rng=rng)
                else:
                    x = synth(rng, f0b, formants, tilt, fs, dur_s)
                write_wav(os.path.join(d, f"{100001 + i}.wav"), x, fs)


def make_vcc2016_corpus(root: str, n_train: int = 50, n_test: int = 5,
                        fs: int = 16000, dur_s: float = 1.5,
                        seed: int = 0, style: str = "vowel",
                        parallel: bool = False) -> None:
    """VCC2016-shaped validation corpus: 10 speakers, ~n_train utt each
    (the real challenge set is 10 x 162; this is the scale-validation
    stand-in since the corpus itself is not downloadable here).
    style="hard" builds the adversarial variant (stop bursts, glides,
    jitter/shimmer, variable rate — synth_hard_utterance);
    parallel=True shares utterance content across speakers (see
    make_corpus — required for meaningful framewise conversion MCD on
    the hard style)."""
    make_corpus(root, n_train=n_train, n_test=n_test, fs=fs, dur_s=dur_s,
                seed=seed, speaker_defs=VCC2016_SPEAKER_DEFS, style=style,
                parallel=parallel)
