"""Speech-shaped test signals with a known f0 trajectory.

The port's own copy of ``tests/conftest.py:make_speech_like`` (that module
imports JAX, which the port never does): the same seven kinds, the same
draws, so the arrays are bit-equal to the JAX tests' fixtures.
"""

from __future__ import annotations

import numpy as np


def make_speech_like(kind, fs=16000, dur_s=1.0, seed=0):
    """Speech-shaped test signals with a known f0 trajectory (VERDICT r2
    item 2: the stationary-tone fixtures could not catch transition or
    sweep regressions).

    Returns (x, f0_true, voiced): f0_true/voiced on the 1 ms grid used to
    synthesize (f0_true[i] = instantaneous f0 at sample i*fs//1000; 0
    where unvoiced).  Kinds:
      sweep       +-1 octave glide 140 -> 280 -> 140 Hz
      vibrato     190 Hz with 5.5 Hz +-3% vibrato
      transitions voiced 0-0.3 s / unvoiced 0.3-0.55 s / voiced 0.55-end
      low_f0      80 Hz (near the 71 Hz floor)
      breathy     170 Hz harmonics under strong broadband noise
      jitter      160 Hz with ~0.8% cycle-rate jitter + 6% shimmer
                  (pathological-voice micro-perturbations, round-5
                  adversarial class)
      bursts      voiced syllables separated by closures with plosive-
                  like broadband bursts at the onsets (round-5
                  adversarial class)
    """
    g = np.random.default_rng(seed)
    n = int(fs * dur_s)
    t = np.arange(n) / fs
    if kind == "sweep":
        f0_t = 140.0 * 2.0 ** np.sin(np.pi * t / dur_s)
        voiced = np.ones(n, bool)
        noise = 0.002
    elif kind == "vibrato":
        f0_t = 190.0 * (1.0 + 0.03 * np.sin(2 * np.pi * 5.5 * t))
        voiced = np.ones(n, bool)
        noise = 0.002
    elif kind == "transitions":
        f0_t = 150.0 + 30.0 * np.sin(2 * np.pi * 0.8 * t)
        voiced = ~((t >= 0.3) & (t < 0.55))
        noise = 0.003
    elif kind == "low_f0":
        f0_t = np.full(n, 80.0)
        voiced = np.ones(n, bool)
        noise = 0.002
    elif kind == "breathy":
        f0_t = np.full(n, 170.0)
        voiced = np.ones(n, bool)
        noise = 0.06
    elif kind == "jitter":
        jit = g.standard_normal(n)
        k = int(0.006 * fs)               # ~1 pitch period at 160 Hz
        jit = np.convolve(jit, np.ones(k) / k, mode="same")
        jit /= max(np.std(jit), 1e-9)
        f0_t = 160.0 * (1.0 + 0.008 * jit)
        voiced = np.ones(n, bool)
        noise = 0.003
    elif kind == "bursts":
        f0_t = 150.0 + 25.0 * np.sin(2 * np.pi * 1.1 * t)
        # three syllables with closures at realistic speech rates
        voiced = (((t >= 0.03) & (t < 0.28)) | ((t >= 0.38) & (t < 0.62))
                  | ((t >= 0.72) & (t < 0.97)))
        noise = 0.003
    else:
        raise ValueError(kind)
    phase = 2.0 * np.pi * np.cumsum(f0_t) / fs
    x = np.zeros(n)
    for h in range(1, 11):
        amp = 0.6 / h
        xh = amp * np.sin(h * phase + 0.1 * h)
        x += np.where(h * f0_t < 0.45 * fs, xh, 0.0)
    if kind == "jitter":
        sh = np.convolve(g.standard_normal(n),
                         np.ones(int(0.01 * fs)) / int(0.01 * fs),
                         mode="same")
        x *= 1.0 + 0.06 * sh / max(np.std(sh), 1e-9)
    # fade voiced region edges over 10 ms to avoid clicks at transitions
    env = voiced.astype(np.float64)
    k = int(0.010 * fs)
    env = np.convolve(env, np.ones(k) / k, mode="same")
    x = x * env + noise * g.standard_normal(n)
    if kind == "bursts":
        # plosive-like broadband bursts just before the 2nd/3rd onsets
        for onset in (0.38, 0.72):
            b0 = int((onset - 0.018) * fs)
            blen = int(0.009 * fs)
            x[b0:b0 + blen] += (0.5 * g.standard_normal(blen)
                                * np.exp(-np.arange(blen) / (0.003 * fs)))
    x = 0.5 * x / np.max(np.abs(x))
    step = fs // 1000
    return x, np.where(voiced, f0_t, 0.0)[::step], voiced[::step]
