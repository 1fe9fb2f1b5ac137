"""The port's nine kernels (tpuvc_torch/ops) against the JAX package.

On the CPU every wrapper takes its plain PyTorch version, so these tests
hold the plain versions against the Pallas kernels run in interpret mode
and against the XLA twins the JAX package runs off the TPU.  The CUDA
kernels cannot run here (no nvcc, no card): the ``gpu`` tests hold each
kernel against its plain version on the card, and ``chip_smoke.py`` does
the same at the main path's shapes.

The module imports no JAX at top level, so that the ``gpu`` tests also
run on a machine without it:
``python -m pytest --noconftest tests/test_torch_ops.py -m gpu``.
"""

import math

import numpy as np
import pytest
import torch

from tpuvc_torch.ops import (_build, conv, d2s, events, harmonics, smooth,
                             topk, window)
from tpuvc_torch.ops.arith import rdiv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run several worker processes on one machine: PyTorch's
    intra-op threads (one per core in each) would contend with the other
    workers on the small shapes here, so each module runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _harmonic(f0, fs=16000, dur_s=0.4, n_harm=10, noise=0.005, seed=0):
    """tests/conftest.py:make_harmonic, without importing the conftest."""
    g = np.random.default_rng(seed)
    t = np.arange(int(fs * dur_s)) / fs
    x = sum((0.6 / h) * np.sin(2 * np.pi * f0 * h * t + 0.1 * h)
            for h in range(1, n_harm + 1))
    x = x + noise * g.standard_normal(t.shape)
    return 0.5 * x / np.max(np.abs(x))


def _speechy(rng, t):
    n = np.arange(t) / 4000.0
    x = (np.sin(2 * np.pi * 170.0 * n)
         + 0.4 * np.sin(2 * np.pi * 340.0 * n + 0.7)
         + 0.05 * rng.standard_normal(t))
    return x.astype(np.float32)


def _zero_ties():
    # exact-zero samples at cell boundaries: duplicate event times
    sig = np.ones(97, np.float32)
    sig[10] = 0.0
    sig[11:20] = -1.0
    sig[40] = 0.0
    sig[41] = 0.0
    sig[60:] = -np.ones(37, np.float32)
    return sig[None]


def _xla_pairs(sig, stride):
    """The JAX XLA twin: dsp/dio.py's cell stage + _block_top2."""
    import jax.numpy as jnp
    from tpuvc.dsp import dio
    d = sig[1:] - sig[:-1]
    outs = []
    for s, off in ((sig, 0.0), (-sig, 0.0), (d, 0.5), (-d, 0.5)):
        m = (s[:-1] > 0) & (s[1:] <= 0)
        frac = jnp.where(m, s[:-1] / jnp.where(m, s[:-1] - s[1:], 1.0), 0.0)
        tpos = jnp.arange(s.shape[0] - 1, dtype=jnp.float32) + frac + off
        nb = -(-(s.shape[0] - 1) // stride)
        outs += dio._block_top2(jnp.where(m, tpos, -jnp.inf), stride, nb,
                                True)
        outs += dio._block_top2(jnp.where(m, tpos, jnp.inf), stride, nb,
                                False)
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("case", ["20-161", "20-3205", "8-512", "ties"])
def test_events_plain_bitexact(case):
    """K1 plain == the Pallas kernel (interpret) == the XLA twin, bit for
    bit (np.array_equal): every output is a selection among event times
    computed with the same IEEE operations in the same order."""
    import jax.numpy as jnp
    from tpuvc.ops.pallas_events import event_block_pairs as jax_pairs
    if case == "ties":
        stride, bank = 8, _zero_ties()
    else:
        stride, t = map(int, case.split("-"))
        rng = np.random.default_rng(t + stride)
        bank = np.stack([_speechy(rng, t) for _ in range(3)])
    got = events.event_block_pairs(torch.from_numpy(bank), stride).numpy()
    nb = -(-(bank.shape[1] - 1) // stride)
    assert got.shape == (bank.shape[0], 16, nb)
    ref = np.asarray(jax_pairs(jnp.asarray(bank), stride, interpret=True))
    assert np.array_equal(got, ref[..., :nb])
    for c in range(bank.shape[0]):
        for row, r in enumerate(_xla_pairs(jnp.asarray(bank[c]), stride)):
            assert np.array_equal(got[c, row, :r.shape[0]], r), (c, row)
    assert _build.read_counts()["events"] == 0   # the CPU path launched nothing


def _nonfinite_bank(case):
    """sin(n/3) over 161 samples with a non-finite sample at 40, or an inf
    at 41 and 45 ("two-inf": cells 40 and 44 are then peaks whose v0 is
    inf, in one block at strides 8 and 20); a finite row beside it."""
    sig = np.sin(np.arange(161) / 3).astype(np.float32)
    clean = sig.copy()
    if case == "two-inf":
        sig[[41, 45]] = np.inf
    else:
        sig[40] = {"+inf": np.inf, "-inf": -np.inf, "nan": np.nan}[case]
    return np.stack([sig, clean])


@pytest.mark.parametrize("stride", [8, 20])
@pytest.mark.parametrize("case", ["+inf", "-inf", "nan", "two-inf"])
def test_events_nonfinite_matches_xla_twin(case, stride):
    """K1 plain == the XLA twin with NaN slots equal (np.array_equal,
    equal_nan): an event at an infinite v0 has the time inf/inf = NaN, and
    both take max/argmax (min/argmin) and remove one instance, so one NaN
    in a block is the first slot and the extreme of the rest the second,
    two or more fill both.  A NaN sample makes no event at all."""
    import jax.numpy as jnp
    bank = _nonfinite_bank(case)
    got = events.event_block_pairs(torch.from_numpy(bank), stride).numpy()
    for c in range(bank.shape[0]):
        for row, r in enumerate(_xla_pairs(jnp.asarray(bank[c]), stride)):
            assert np.array_equal(got[c, row, :r.shape[0]], r,
                                  equal_nan=True), (c, row)
    assert np.isnan(got).any() == (case != "nan")
    assert not np.isnan(got[1]).any()


def _events_tiled(bank, stride, tile):
    """csrc/events.cu's decomposition rendered in torch: CTAs of ``tile``
    blocks stage their span of the row and a 2-sample halo (zeros past T).
    A span with every sample below 2^126 in magnitude (stride <= 32,
    T <= 2^24) takes the fast path: each type's events as a mask per
    block, and times computed only at the first two and last two events,
    which are the block's sorted top-2 since a type's times never
    decrease along the row.  Any other span takes the generic path: the
    per-cell sorted-pair insert with NaN times counted apart."""
    r, t = bank.shape
    nb = events.n_blocks(t, stride)
    out = torch.empty((r, 16, nb))
    inf = torch.tensor(torch.inf)
    for row in range(r):
        for k0 in range(0, nb, tile):
            span = torch.zeros(tile * stride + 4)
            g0 = k0 * stride
            n_in = max(min(t - g0, span.numel()), 0)
            span[:n_in] = bank[row, g0:g0 + n_in]
            kk = torch.arange(k0, min(k0 + tile, nb))
            if (stride <= 32 and t <= 2 ** 24
                    and not bool((span.abs() >= 2.0 ** 126).any())):
                out[row, :, kk] = _fast_tile(span, kk - k0, kk, stride, t,
                                             inf)
            else:
                for k in kk.tolist():
                    out[row, :, k] = _generic_block(span, k - k0, k, stride, t)
    return out


def _type_values(span, loc):
    """The four types' (v0, v1) at span positions ``loc`` (cell samples
    a, b, c at loc, loc + 1, loc + 2), with their offsets."""
    a, b, c = span[loc], span[loc + 1], span[loc + 2]
    d0, d1 = b - a, c - b
    return ((a, b, 0.0), (-a, -b, 0.0), (d0, d1, 0.5), (-d0, -d1, 0.5))


def _fast_tile(span, local, kk, stride, t, inf):
    j = torch.arange(stride)
    loc = local[:, None] * stride + j                        # [blocks, stride]
    cell = kk[:, None] * stride + j
    rows = []
    for e, (v0, v1, off) in enumerate(_type_values(span, loc)):
        m = (v0 > 0) & (v1 <= 0) & (cell < (t - 1 if e < 2 else t - 2))
        n = m.sum(-1)
        first = m.int().argmax(-1)
        second = (m & (j != first[:, None])).int().argmax(-1)
        last = stride - 1 - m.flip(-1).int().argmax(-1)
        rest = m & (j != last[:, None])
        prev = stride - 1 - rest.flip(-1).int().argmax(-1)

        def time(jj, ok):
            # divide only at the chosen event cells
            g0 = v0.gather(1, jj[:, None])[:, 0]
            g1 = v1.gather(1, jj[:, None])[:, 0]
            frac = torch.where(ok, g0 / torch.where(ok, g0 - g1, 1.0), 0.0)
            return (kk * stride + jj).float() + frac + off

        rows += [torch.where(n >= 1, time(last, n >= 1), -inf),
                 torch.where(n >= 2, time(prev, n >= 2), -inf),
                 torch.where(n >= 1, time(first, n >= 1), inf),
                 torch.where(n >= 2, time(second, n >= 2), inf)]
    return torch.stack(rows)


def _generic_block(span, local, k, stride, t):
    pairs = [[-torch.inf, -torch.inf, torch.inf, torch.inf] for _ in range(4)]
    nans = [0] * 4
    f32 = torch.float32
    for j in range(stride):
        i = k * stride + j
        loc = torch.tensor([local * stride + j])
        for e, (v0, v1, off) in enumerate(_type_values(span, loc)):
            if not (bool(v0 > 0) and bool(v1 <= 0)
                    and i < (t - 1 if e < 2 else t - 2)):
                continue
            tp = float(torch.tensor(float(i), dtype=f32) + v0 / (v0 - v1)
                       + off)
            if math.isnan(tp):
                nans[e] += 1
                continue
            p = pairs[e]
            p[1], p[0] = max(p[1], min(p[0], tp)), max(p[0], tp)
            p[3], p[2] = min(p[3], max(p[2], tp)), min(p[2], tp)
    for p, n in zip(pairs, nans):
        if n >= 2:
            p[:] = [math.nan] * 4
        elif n == 1:
            p[:] = [math.nan, p[0], math.nan, p[2]]
    return torch.tensor(pairs, dtype=f32).reshape(16)


def _events_case(case):
    """(stride, bank [R, T] float32) of a K1 case: '<stride>-<T>x<R>'
    speech-like rows, the ties bank, or a non-finite or oversized sample
    in speech-like rows ('<stride>-<T>x<R>:<value>@<sample>', row 0)."""
    if case == "ties":
        return 8, _zero_ties()
    spec, _, bad = case.partition(":")
    stride, rest = spec.split("-")
    t, r = map(int, rest.split("x"))
    rng = np.random.default_rng(t + int(stride))
    bank = np.stack([_speechy(rng, t) for _ in range(r)])
    if bad:
        value, at = bad.split("@")
        bank[0, int(at)] = np.float32(value)
    return int(stride), bank


@pytest.mark.parametrize("case,tile", [
    ("3-161x2", 4), ("8-512x3", 4), ("20-3205x2", 128), ("20-3207x2", 7),
    ("32-1000x2", 3), ("40-1000x2", 2), ("ties", 3), ("8-640x2:inf@300", 4),
    ("20-640x2:-inf@41", 4), ("20-640x2:3e38@100", 2)])
def test_events_tiling_matches_plain(case, tile):
    """The kernel's decomposition, rendered in torch (_events_tiled), equals
    the plain version bit for bit (NaN slots equal): tile spans with their
    halo, the clipped tail, ragged last tiles, strides 3 to 40 (40 takes
    the generic path), and spans sent to the generic path by an inf or a
    finite sample at or above 2^126 beside spans on the fast path."""
    stride, bank = _events_case(case)
    tb = torch.from_numpy(bank)
    ref = events.event_block_pairs_plain(tb, stride).numpy()
    got = _events_tiled(tb, stride, tile).numpy()
    assert np.array_equal(got, ref, equal_nan=True)


def _frames(n=23, w=1024, seed=0):
    x = _harmonic(172.0, seed=seed)
    from tpuvc_torch.ops.framing import frame_signal
    seg = frame_signal(torch.tensor(x, dtype=torch.float32)[None], 80, w,
                       n)[0]
    return x, seg


@pytest.mark.parametrize("fold", [True, False])
def test_harmonic_dft_plain_matches_pallas(fold):
    """K2 plain == harmonic_dft_pallas (interpret), fold on and off.
    rtol 1e-4 / atol 1e-4 of the largest output: the two sum the same
    products in another order over up to 1024 lanes in float32."""
    import jax.numpy as jnp
    from tpuvc.ops.pallas_harmonics import harmonic_dft_pallas
    rng = np.random.default_rng(1)
    _, seg = _frames()
    n = seg.shape[0]
    f0 = rng.uniform(60.0, 500.0, (n, 2)).astype(np.float32)
    f0[3, 0] = 0.0                       # clamped like an unvoiced row
    ref = harmonic_dft_pallas(jnp.asarray(seg.numpy()), jnp.asarray(f0),
                              16000, with_if=True, interpret=True,
                              fold=fold)
    got = harmonics.harmonic_dft(seg, torch.from_numpy(f0), 16000,
                                 with_if=True, fold=fold)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())
    xre, xim, dre, dim_, en = harmonics.harmonic_dft(
        seg, torch.from_numpy(f0), 16000, with_if=False, fold=fold)
    assert dre is None and dim_ is None
    np.testing.assert_allclose(en.numpy(), np.asarray(ref[4]), rtol=1e-4)


def test_stonemask_refine_matches_xla():
    """The port's refinement pass (through K2's plain version) ==
    stonemask._refine_once, the XLA formulation the JAX package runs off
    the TPU: rtol 5e-4, atol 5e-2 Hz, the bound tests/test_ops.py holds
    the Pallas kernel to (reduction-order rounding through the IF ratio)."""
    import jax.numpy as jnp
    from tpuvc.dsp.stonemask import _refine_once
    from tpuvc_torch.dsp.stonemask import _refine_once as port_refine
    _, seg = _frames(n=81)
    n = seg.shape[0]
    f0 = np.maximum(np.where(np.arange(n) % 7 == 3, 0.0, 172.0)
                    + np.linspace(-2, 2, n), 0.0).astype(np.float32)
    ref = np.asarray(_refine_once(jnp.asarray(seg.numpy()),
                                  jnp.asarray(f0), 16000))
    got = port_refine(seg, torch.from_numpy(f0), 16000).numpy()
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-2)


def test_window_plain_matches_xla():
    """K3 plain == cheaptrick._windowed_frames (XLA path), rtol 1e-5 /
    atol 1e-6 as tests/test_ops.py holds the Pallas kernel; the half
    length rounds half to even in both (jnp.rint / torch.round)."""
    import jax.numpy as jnp
    from tpuvc.dsp import cheaptrick as ct
    rng = np.random.default_rng(0)
    fs, w, hop, n = 16000, 1024, 80, 21
    x = rng.standard_normal(n * hop + 1).astype(np.float32)
    f0 = rng.uniform(80, 500, n).astype(np.float32)
    # 24000/f0 is exactly 74.5 under one rounding (rint -> 74) but
    # 74.500008 as 24000 * (1/f0) (-> 75): the half length must come from
    # a true division, as in JAX and the kernel (tpuvc_torch/ops/arith.py)
    f0[0] = 322.14764404296875
    seg_ref, wp_ref = ct._windowed_frames(jnp.asarray(x), jnp.asarray(f0),
                                          hop, fs, w)
    from tpuvc_torch.ops.framing import frame_signal
    seg_raw = frame_signal(torch.from_numpy(x)[None], hop, w, n)[0]
    seg, wp = window.windowed_frames(seg_raw, torch.from_numpy(f0), fs)
    np.testing.assert_allclose(seg.numpy(), np.asarray(seg_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wp_ref), rtol=1e-5)


# f0 in Hz: a support that covers the whole row (h >= 512 below 46.875
# Hz), the exact-half case (h = rint(74.5) = 74), 900 Hz and the unvoiced
# default
_WINDOW_F0 = [40.0, 46.0, 47.0, 322.14764404296875, 500.0, 900.0]


def test_window_support_is_the_plain_mask():
    """The kernel's support [W/2 - h, W/2 + h] clipped to [0, W) (window.
    support) is the plain version's mask |col - W/2| <= rint(1.5 fs/f0),
    for f0 from 40 to 900 Hz, the exact-half case and whole-row supports."""
    fs, w = 16000, 1024
    f0 = torch.cat([torch.linspace(40.0, 900.0, 2000),
                    torch.tensor(_WINDOW_F0)])
    lo, hi = window.support(f0, fs, w)
    col = torch.arange(w)
    got = (col >= lo[:, None]) & (col <= hi[:, None])
    half_len = torch.round(rdiv(1.5 * fs, f0)).to(torch.int64)
    mask = (col - w // 2).abs()[None, :] <= half_len[:, None]
    assert torch.equal(got, mask)
    special = got[-len(_WINDOW_F0):]
    assert bool(special[:2].all()) and not bool(special[2].all())
    assert int(hi[-3] - lo[-3]) == 2 * 74


def _nonfinite_wave():
    """A 0.3 s vowel at 180 Hz (some frames unvoiced) with a NaN at sample
    1000 and an inf at 4000: the NaN lies outside the window support
    (+-133 samples at 180 Hz) of the frames centred 134-512 samples from
    it, the inf inside the support of frame 50."""
    rng = np.random.default_rng(12)
    t = np.arange(4800) / 16000
    x = (0.3 * np.sin(2 * np.pi * 180 * t)
         + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
    x[1000], x[4000] = np.nan, np.inf
    f0 = np.full(61, 180.0, np.float32)
    f0[::9] = 0.0
    return torch.from_numpy(x)[None], torch.from_numpy(f0)[None]


def test_cheaptrick_nonfinite_rows_match_jax():
    """CheapTrick on a waveform with a NaN outside some frames' window
    support and an inf inside another's: the port's all-NaN rows are the
    JAX package's (x * 0 is NaN there, and it enters the mean), and the
    finite rows agree within test_cheaptrick_matches_jax's bounds (0.5 dB
    per bin, 0.05 dB on average).  Frames whose support misses the NaN are
    among the NaN rows."""
    import jax.numpy as jnp
    from tpuvc.dsp import cheaptrick as jct
    from tpuvc_torch.dsp.cheaptrick import cheaptrick
    x, f0 = _nonfinite_wave()
    ref = np.asarray(jct.cheaptrick(jnp.asarray(x[0].numpy()),
                                    jnp.asarray(f0[0].numpy())))
    got = cheaptrick(x, f0)[0].numpy()
    nan_rows = np.isnan(ref).all(-1)
    assert np.array_equal(np.isnan(got).all(-1), nan_rows)
    assert not np.isnan(got[~nan_rows]).any()
    assert not np.isnan(ref[~nan_rows]).any()
    centre = np.arange(len(nan_rows)) * 80
    assert nan_rows[(np.abs(centre - 1000) > 133)
                    & (np.abs(centre - 1000) <= 512)].all()
    db = 10.0 * np.log10(got[~nan_rows] / ref[~nan_rows])
    assert np.abs(db).max() < 0.5 and np.abs(db).mean() < 0.05


@pytest.mark.parametrize("t,hop,window,n", [(4800, 80, 1024, 61),
                                            (700, 80, 1024, 12),
                                            (333, 5, 64, 80)])
def test_nonfinite_frames_match_framed_signal(t, hop, window, n):
    """ops/framing.nonfinite_frames (a prefix count over the padded
    signal) flags exactly the frames of frame_signal that hold a NaN or
    inf, at the frame edges too; a signal shorter than a window, and
    frames past its end."""
    from tpuvc_torch.ops.framing import frame_signal, nonfinite_frames
    rng = np.random.default_rng(t)
    x = rng.standard_normal((3, t)).astype(np.float32)
    x[0, [0, t // 2, t - 1]] = [np.nan, np.inf, -np.inf]
    x[1, rng.integers(0, t, 4)] = np.nan
    x = torch.from_numpy(x)
    want = ~torch.isfinite(frame_signal(x, hop, window, n)).all(-1)
    got = nonfinite_frames(x, hop, window, n)
    assert bool(want.any()) and not bool(want[2].any())
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [6, 37])
def test_window_plain_ignores_columns_outside_support(n):
    """The premise of K3's kernel: what lies outside a frame's support
    does not change the plain version's output (torch.equal): it is
    multiplied by a zero window and adds +-0 to the sums.  Columns outside
    the support replaced by large finite values."""
    rng = np.random.default_rng(11)
    fs, w = 16000, 1024
    seg = torch.from_numpy(rng.standard_normal((n, w)).astype(np.float32))
    f0 = torch.from_numpy(rng.uniform(40, 900, n).astype(np.float32))
    f0[:len(_WINDOW_F0)] = torch.tensor(_WINDOW_F0[:n])
    lo, hi = window.support(f0, fs, w)
    col = torch.arange(w)
    outside = (col < lo[:, None]) | (col > hi[:, None])
    big = torch.from_numpy(rng.choice([-3e38, 3e38, 1e30], (n, w)).astype(
        np.float32))
    ref = window.windowed_frames_plain(seg, f0, fs)
    got = window.windowed_frames_plain(torch.where(outside, big, seg), f0, fs)
    assert bool(outside.any()) and not bool(outside[0].any())
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_box_smooth_plain_matches_xla_pallas_and_oracle():
    """K4 plain == spectral.linear_smoothing (XLA) and box_smooth_pallas
    (interpret), rtol 1e-5 / atol 1e-12 as tests/test_ops.py; and one
    frame against the float64 oracle, rtol 1e-4 (float32 vs float64)."""
    import jax.numpy as jnp
    from tests.oracle.common import linear_smoothing as oracle_smooth
    from tpuvc.dsp.spectral import linear_smoothing
    from tpuvc.ops.pallas_smooth import box_smooth_pallas
    rng = np.random.default_rng(1)
    fs, fft_size, n = 16000, 1024, 37
    ps = (10.0 ** rng.uniform(-8, 0, (n, fft_size // 2 + 1))).astype(
        np.float32)
    width = rng.uniform(60, 790, n).astype(np.float32)
    width[0] = 900.0                       # clamped to max_width_hz
    got = smooth.box_smooth(torch.from_numpy(ps), torch.from_numpy(width),
                            fs, fft_size, 810.0).numpy()
    ref = np.asarray(linear_smoothing(jnp.asarray(ps), jnp.asarray(width),
                                      fs, fft_size, floor_rel=None))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)
    pal = np.asarray(box_smooth_pallas(jnp.asarray(ps), jnp.asarray(width),
                                       fs, fft_size, 810.0, interpret=True))
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-12)
    o = oracle_smooth(ps[1].astype(np.float64), float(width[1]), fs,
                      fft_size)
    np.testing.assert_allclose(got[1], o, rtol=1e-4, atol=1e-10)


def _smooth_rows(cap, signed, n=40, seed=11):
    """Spectra (signed ones as D4C's f0/2 site smooths) and widths from
    below one bin (15.625 Hz) to above the cap."""
    rng = np.random.default_rng(seed)
    ps = 10.0 ** rng.uniform(-8, 0, (n, 513))
    if signed:
        ps = ps * rng.choice([-1.0, 1.0], ps.shape)
    width = np.concatenate([[3.0, 15.0, 15.625, 16.0, cap, cap + 150.0],
                            rng.uniform(3.0, cap + 200.0, n - 6)])
    return (torch.from_numpy(ps.astype(np.float32)),
            torch.from_numpy(width.astype(np.float32)))


@pytest.mark.parametrize("step", [1, 8])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("cap", [810.0, 1056.0])
def test_box_smooth_nonzero_span_is_bit_equal(cap, signed, step):
    """The premise of the smoothing kernel's tap trimming: summing, in
    ascending order, only the taps from a frame's first to its last
    nonzero weight (rounded up to whole steps of ``step`` taps, with zero
    weights past 2K and a zero-padded row, as the kernel runs them) gives
    box_smooth_plain bit for bit on finite spectra (torch.equal).  The
    weights come from smooth.box_weights, so this also holds them equal to
    the plain version's."""
    fs, fft_size = 16000, 1024
    ps, width = _smooth_rows(cap, signed)
    n, half = ps.shape
    k = smooth.n_taps_half(fs, fft_size, cap)
    wgt = smooth.box_weights(width, fs, fft_size, cap)
    nz = wgt != 0.0
    assert not bool(nz.all(dim=1).any())        # every frame trims taps
    has = nz.any(dim=1)
    lo = torch.where(has, nz.int().argmax(dim=1), 0)
    hi = torch.where(has, 2 * k - nz.flip(1).int().argmax(dim=1), -1)
    steps = torch.div(hi - lo + step, step, rounding_mode="floor")
    wgt = torch.cat([wgt, torch.zeros((n, step))], dim=1)
    ext = torch.cat([smooth.mirror_extend(ps, k), torch.zeros((n, step))],
                    dim=1)
    f = torch.arange(half)[None, :]
    sm = torch.zeros_like(ps)
    for t in range(int((steps * step).max())):
        tap = lo + t                              # [N]
        on = (t < steps * step)[:, None]
        g = wgt.gather(1, torch.clamp(tap, max=wgt.shape[1] - 1)[:, None])
        e = ext.gather(1, torch.clamp(tap[:, None] + f, max=ext.shape[1] - 1))
        sm = torch.where(on, sm + e * g, sm)
    assert torch.equal(sm, smooth.box_smooth_plain(ps, width, fs, fft_size,
                                                   cap))


@pytest.mark.parametrize("half,k", [(513, 1), (513, 27), (513, 35),
                                    (513, 511), (9, 1), (9, 7)])
def test_smooth_reflection_map_matches_mirror_extend(half, k):
    """The smoothing kernel stages the extended row straight from ps with
    i < 0 -> -i, i >= half -> 2 (half - 1) - i (i = ext index - k): that
    index map is mirror_extend."""
    rng = np.random.default_rng(half + k)
    ps = torch.from_numpy(rng.standard_normal((3, half)).astype(np.float32))
    e = torch.arange(half + 2 * k) - k
    idx = torch.where(e < 0, -e, torch.where(e >= half, 2 * (half - 1) - e,
                                             e))
    assert torch.equal(ps[:, idx], smooth.mirror_extend(ps, k))


@pytest.mark.parametrize("w", [1024, 1000])
@pytest.mark.parametrize("fold", [True, False])
def test_derivative_window_from_lane_neighbours(fold, w):
    """The harmonic kernel's lanes b = j * 32 + lane take win[b - 1] and
    win[b + 1] from the adjacent lanes, at lane 0 from the previous block's
    lane 31 and at lane 31 from the next block's lane 0 (0 past the ends),
    and zero the derivative at b = 0 and b >= lanes - 1: the derivative
    window so formed gives _slot_folded's (or _slot's) d_re and d_im bit
    for bit.  W = 1000 leaves a partial last block of 32."""
    fs = 16000.0
    rng = np.random.default_rng(w)
    seg = torch.from_numpy(rng.standard_normal((9, w)).astype(np.float32))
    f0 = torch.from_numpy(np.array(
        [harmonics.fold_floor(w, fs), 60.0, 95.5, 172.0, 250.0, 401.0, 800.0,
         1500.0, 3000.0], np.float32))[:, None]
    lanes = w // 2 if fold else w
    b = torch.arange(lanes, dtype=torch.float32)[None, :]
    pos = b if fold else b - w // 2
    half_len = torch.floor(harmonics.rdiv(1.5 * fs, f0) + 1.0)
    cp = torch.cos((2.0 * np.pi / (3.0 * fs)) * f0 * pos)
    zero = torch.zeros(())
    win = torch.where(torch.abs(pos) <= half_len,
                      0.42 + 0.5 * cp + 0.08 * (2.0 * cp * cp - 1.0), zero)
    nj = -(-lanes // 32)
    blocks = torch.cat([win, torch.zeros((9, nj * 32 - lanes))],
                       dim=1).reshape(9, nj, 32)
    zcol = torch.zeros((9, nj, 1))
    prev31 = torch.cat([torch.zeros((9, 1)), blocks[:, :-1, 31]], dim=1)
    next0 = torch.cat([blocks[:, 1:, 0], torch.zeros((9, 1))], dim=1)
    up = torch.cat([zcol, blocks[:, :, :31]], dim=2)          # shfl_up 1
    down = torch.cat([blocks[:, :, 1:], zcol], dim=2)         # shfl_down 1
    lane = torch.arange(32)
    wl = torch.where(lane == 0, prev31[:, :, None], up)
    wr = torch.where(lane == 31, next0[:, :, None], down)
    bb = (torch.arange(nj)[:, None] * 32 + lane).reshape(-1)[:lanes]
    edge = (bb == 0) | (bb >= lanes - 1)
    dwin = torch.where(edge, zero, -0.5 * (wr - wl).reshape(9, -1)[:, :lanes])
    sp = torch.sin((2.0 * np.pi / (3.0 * fs)) * f0 * pos)
    if fold:
        e, o = harmonics._fold_eo(seg)
        mask = torch.abs(pos) <= half_len
        em, om = torch.where(mask, e, zero), torch.where(mask, o, zero)
        ref = harmonics._slot_folded((e, o), f0, fs, 6, True)
    else:
        em = om = torch.where(torch.abs(pos) <= half_len, seg, zero)
        ref = harmonics._slot(seg, f0, fs, 6, True)
    de, do = em * dwin, om * dwin
    dre, dim_ = [], []
    for ch, sh in harmonics._recurrence(cp, sp, 6):
        dre.append(torch.sum(do * ch, dim=-1))
        dim_.append(-torch.sum(de * sh, dim=-1))
    assert torch.equal(torch.stack(dre, dim=-1), ref[2])
    assert torch.equal(torch.stack(dim_, dim=-1), ref[3])


def _tied_rows(seed=3, n=50, c=512):
    """Uniform rows plus the tie patterns of tests/test_ops.py:263."""
    rng = np.random.default_rng(seed)
    ps = rng.uniform(0, 1, (n, c)).astype(np.float32)
    ps[7, :100] = 0.5          # heavy ties
    ps[13] = 0.0               # all-equal row
    ps[21, ::2] = ps[21, 1::2]  # pairwise duplicates
    return ps


@pytest.mark.parametrize("kk", [1, 21, 512])
def test_topk_sum_plain_matches_pallas_and_lax(kk):
    """K5 plain == topk_sum_pallas (interpret) bit for bit: both pick the
    maxima in the same order and add them in that order.  Against the sum
    of lax.top_k (a sort, summed by XLA in another order): rtol 1e-6, the
    bound tests/test_ops.py holds the Pallas kernel to."""
    import jax
    import jax.numpy as jnp
    from tpuvc.ops.pallas_topk import topk_sum_pallas
    ps = _tied_rows()
    got = topk.topk_sum(torch.from_numpy(ps), kk).numpy()
    pal = np.asarray(topk_sum_pallas(jnp.asarray(ps), kk, interpret=True))
    assert np.array_equal(got, pal)
    ref = np.sum(np.asarray(jax.lax.top_k(jnp.asarray(ps), kk)[0]), -1)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert _build.read_counts()["topk"] == 0


def _topk_rows(c, seed=9):
    """Rows of c values: uniform, the tie patterns of _tied_rows (c = 512),
    signed zeros alone and among values, all-equal rows and rows with -inf
    padding."""
    rng = np.random.default_rng(seed)
    ps = rng.uniform(0, 1, (12, c)).astype(np.float32)
    zeros = np.where(rng.uniform(size=c) < 0.5, 0.0, -0.0).astype(np.float32)
    ps[0] = zeros                          # only +0 and -0
    ps[1] = np.where(rng.uniform(size=c) < 0.8, zeros, ps[1])
    ps[2] = np.where(rng.uniform(size=c) < 0.5, zeros, -ps[2])
    ps[3] = 0.25                           # all equal
    ps[4] = -3.0
    ps[5, 100:] = -np.inf                  # padding past 100 values
    ps[6, ::3] = -np.inf
    ps[7, :64] = 0.5                       # heavy ties
    ps[8] = np.round(ps[8] * 4) / 4        # few distinct values
    if c == 512:
        ps = np.concatenate([ps, _tied_rows(n=24)])
    return ps


def _topk_sum_merge(ps, kk, layout):
    """csrc/topk.cu's algorithm in torch: each of 32 lanes sorts its group
    of 16 columns (padded with -inf) in non-increasing order; kk rounds
    add the maximum of the lane heads to a sum started at +0, and the
    lowest lane holding it pops its head.  ``layout`` is the kernel's float4
    one (lane l holds 4 (l + 32 j) + e) or its scalar one (l + 32 j)."""
    n, c = ps.shape
    pad = torch.full((n, topk.MAX_COLS), -torch.inf)
    pad[:, :c] = ps
    if layout == "float4":
        lanes = pad.reshape(n, 4, 32, 4).transpose(1, 2).reshape(n, 32, 16)
    else:
        lanes = pad.reshape(n, 16, 32).transpose(1, 2)
    v = torch.sort(lanes, dim=-1, descending=True).values
    tail = torch.full((n, 32, 1), -torch.inf)
    acc = torch.zeros(n)
    for _ in range(kk):
        m = v[:, :, 0].amax(-1)
        first = (v[:, :, 0] == m[:, None]).int().argmax(-1)
        pop = torch.arange(32) == first[:, None]
        v = torch.where(pop[:, :, None], torch.cat([v[:, :, 1:], tail], -1),
                        v)
        acc = acc + m
    return acc


@pytest.mark.parametrize("layout", ["float4", "scalar"])
@pytest.mark.parametrize("kk", [1, 21, "c"])
@pytest.mark.parametrize("c", [385, 512])
def test_topk_sorted_lane_merge_is_bit_equal(c, kk, layout):
    """The premise of K5's kernel: merging 32 sorted lanes by their heads
    picks the row's values in non-increasing order, so its sum from +0 has
    the plain version's bits (torch.equal on the int32 view: the same
    sign of zero too), under ties, signed zeros and -inf padding."""
    ps = torch.from_numpy(_topk_rows(c))
    kk = c if kk == "c" else kk
    ref = topk.topk_sum_plain(ps, kk)
    got = _topk_sum_merge(ps, kk, layout)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _refine_rows(n=300, w=768, seed=2, fs=16000):
    """Frame-centred harmonic segments and a candidate table with mixed
    empty slots: slot 0 near the truth (holes every 7th row), octave
    errors, candidates ~19% off (the accept gate's edge) and ones at the
    search floor."""
    rng = np.random.default_rng(seed)
    t = (np.arange(w) - w // 2) / fs
    f_true = 120.0 + np.arange(n)
    seg = np.stack([sum((0.6 / h) * np.sin(2 * np.pi * h * f * t + 0.1 * h)
                        for h in range(1, 9)) for f in f_true])
    seg = (seg + 0.01 * rng.standard_normal(seg.shape)).astype(np.float32)
    f0 = np.zeros((n, 10), np.float32)
    f0[:, 0] = f_true + rng.uniform(-3, 3, n)
    f0[::3, 1] = 2.0 * f0[::3, 0]
    f0[1::4, 2] = 1.19 * f0[1::4, 0]
    f0[5::11, 4] = 63.9
    f0[::7, 0] = 0.0
    return seg, f0


def test_refine_score_plain_matches_pallas():
    """K6 plain == refine_score_pallas (interpret, fold on) on 300 rows
    with mixed empty slots.  Both run _refine_math on folded sums taken in
    another order (reduction-order rounding through the IF ratio): the
    bounds tests/test_ops.py holds the merged kernel to against the split
    route, rtol 1e-5 / atol 1e-4 Hz for refined f0 and rtol 1e-4 / atol
    1e-5 for the score; empty and rejected slots are 0 in both."""
    import jax.numpy as jnp
    from tpuvc.ops.pallas_harmonics import refine_score_pallas
    seg, f0 = _refine_rows()
    ref = refine_score_pallas(jnp.asarray(seg), jnp.asarray(f0), 16000,
                              floor=63.9, limit=0.2, interpret=True)
    got = harmonics.refine_score(torch.from_numpy(seg), torch.from_numpy(f0),
                                 16000, 63.9, 0.2)
    r_ref, s_ref = (np.asarray(v) for v in ref)
    r_got, s_got = (v.numpy() for v in got)
    assert np.array_equal(r_got > 0, r_ref > 0)
    assert (r_got > 0).sum() > 300 and (r_got[:, 5:] == 0).all()
    np.testing.assert_allclose(r_got, r_ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s_got, s_ref, rtol=1e-4, atol=1e-5)
    assert _build.read_counts()["refine"] == 0


def _adversarial_pairs(nb, seed=5, c=3):
    """Sorted block pairs as event_block_pairs makes them, with the
    adversarial patterns of tests/test_events.py: empty blocks (fills),
    single-event blocks, duplicate times (multiplicity)."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 1e4, (c, 4, 2, nb)).astype(np.float32),
                    axis=2)
    empty = rng.random((c, 4, nb)) < 0.35
    half = rng.random((c, 4, nb)) < 0.25
    dup = rng.random((c, 4, nb)) < 0.2
    pairs = np.empty((c, 16, nb), np.float32)
    for ti in range(4):
        hi, lo = times[:, ti, 1], times[:, ti, 0]
        hi2 = np.where(dup[:, ti], hi, lo)
        s1 = np.where(empty[:, ti], np.inf, hi2)
        s2 = np.where(empty[:, ti] | half[:, ti], np.inf, hi)
        pairs[:, 4 * ti + 0] = np.where(empty[:, ti], -np.inf, hi)
        pairs[:, 4 * ti + 1] = np.where(empty[:, ti] | half[:, ti], -np.inf,
                                        hi2)
        pairs[:, 4 * ti + 2] = np.minimum(s1, s2)
        pairs[:, 4 * ti + 3] = np.maximum(s1, s2)
    return pairs


@pytest.mark.parametrize("nb", [256, 161])
def test_scan_plain_matches_pallas(nb):
    """K7 plain == top2_block_scans (interpret), bit for bit
    (np.array_equal): every output is a selection among the inputs.  The
    Pallas kernel needs nb to be a multiple of its lane tile, so at
    nb = 161 its input is padded to 256 with fill blocks (-inf in the max
    rows, +inf in the min rows), which are inert in both directions."""
    import jax.numpy as jnp
    from tpuvc.ops.pallas_events import top2_block_scans as jax_scans
    pairs = _adversarial_pairs(nb)
    padded = np.empty((3, 16, 256), np.float32)
    padded[:, :, :nb] = pairs
    for row in range(16):
        padded[:, row, nb:] = -np.inf if row % 4 < 2 else np.inf
    ref = np.asarray(jax_scans(jnp.asarray(padded), interpret=True))
    got = events.top2_block_scans(torch.from_numpy(pairs)).numpy()
    assert got.shape == pairs.shape
    assert np.array_equal(got, ref[..., :nb])
    assert _build.read_counts()["scan"] == 0


@pytest.mark.parametrize("stride,l,cin,cout,k", [
    (3, 57, 16, 32, 7), (1, 19, 8, 16, 7), (3, 513, 1, 8, 7)])
def test_conv_plain_matches_pallas(stride, l, cin, cout, k):
    """K8 plain == conv_ln_lrelu (interpret) at the shapes of
    tests/test_ops.py's kernel test, rtol 2e-4 / atol 2e-5 as there: the
    same float32 products summed in another order, then normalised."""
    import jax.numpy as jnp
    from tpuvc.ops.pallas_conv import conv_ln_lrelu
    rng = np.random.default_rng(stride + l + cin)
    x = rng.standard_normal((5, l, cin)).astype(np.float32)
    w = (0.2 * rng.standard_normal((k, cin, cout))).astype(np.float32)
    b, bt = (0.1 * rng.standard_normal((2, cout))).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(cout)).astype(np.float32)
    ref = np.asarray(conv_ln_lrelu(*(jnp.asarray(a) for a in (x, w, b, g,
                                                               bt)),
                                   stride, 0.2, interpret=True))
    got = conv.conv_ln_lrelu(*(torch.from_numpy(a) for a in (x, w, b, g, bt)),
                             stride, 0.2).numpy()
    assert got.shape == ref.shape == (5, -(-l // stride), cout)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    assert _build.read_counts()["conv"] == 0


# the encoder's five layers at stride 3: L, Cin, Cout (K = 7)
_ENCODER = [(513, 1, 16), (171, 16, 32), (57, 32, 64), (19, 64, 128),
            (7, 128, 256)]


def _conv_inputs(case, n, l, cin, cout, seed=0):
    """x [n, l, cin] and the layer's parameters.  "uniform": x in [-1, 1),
    w ~ N(0, 1/(7 Cin)); "tiny variance": every output channel's weights
    one shared draw plus 5% of their own, and one bias, so a row's
    channels spread ~20x less than their common part and the norm scales
    the product's error up as much (much tighter rows leave float32's own
    rounding of the sums, so amplified, too near the bound to hold a kernel
    to it); "x 1e3": the uniform inputs scaled by 1e3."""
    rng = np.random.default_rng(seed + cout)
    x = rng.uniform(-1, 1, (n, l, cin)).astype(np.float32)
    w = rng.standard_normal((7, cin, cout)) / np.sqrt(7 * cin)
    b, g, bt = (0.1 * rng.standard_normal(cout) + o for o in (0, 1, 0))
    if case == "tiny variance":
        w = w[:, :, :1] + 0.05 * w
        b = np.full(cout, 0.1)
    elif case == "x 1e3":
        x = x * np.float32(1e3)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 for a in (x, w, b, g, bt))


def _tf32(v):
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero, on the bit pattern: what cvt.rna.tf32.f32 does."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _conv_ln_lrelu_split(x, w, b, g, bt, stride, slope, passes):
    """conv_ln_lrelu_plain with the convolution's float32 operands split
    into TF32 hi + lo: passes 3 sums lo*hi + hi*lo + hi*hi (csrc/conv.cu's
    tensor-core route; each TF32 product is exact in float32), passes 1
    takes hi*hi alone (plain TF32)."""
    import torch.nn.functional as F

    def conv1d(xv, wv):
        xc = F.pad(xv.transpose(1, 2), conv.same_pad(xv.shape[1],
                                                      wv.shape[0], stride))
        return F.conv1d(xc, wv.permute(2, 1, 0), stride=stride)
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    y = conv1d(xh, wh)
    if passes == 3:
        y = conv1d(xl, wh) + conv1d(xh, wl) + y
    y = (y + b[:, None]).transpose(1, 2)
    y = F.layer_norm(y, y.shape[-1:], g, bt, conv.LN_EPS)
    return F.leaky_relu(y, slope)


@pytest.mark.parametrize("case", ["uniform", "tiny variance", "x 1e3"])
@pytest.mark.parametrize("l,cin,cout", _ENCODER)
def test_conv_split_tf32_matches_plain(l, cin, cout, case):
    """The premise of K8's tensor-core route: split TF32 (three TF32
    products per float32 one, summed in float32) through the conv,
    LayerNorm and LeakyReLU stays within the rtol 1e-4 / atol 1e-4 that
    the kernel is held to against conv_ln_lrelu_plain, at the encoder's
    five layer shapes over 300 frames, on rows whose norm amplifies the
    product's error and on inputs scaled by 1e3.  Plain TF32 (one
    product) is printed for the record, not asserted."""
    args = _conv_inputs(case, 300, l, cin, cout)
    ref = conv.conv_ln_lrelu_plain(*args, 3, 0.2)
    got = _conv_ln_lrelu_split(*args, 3, 0.2, passes=3)
    one = _conv_ln_lrelu_split(*args, 3, 0.2, passes=1)
    err = lambda v: float(((v - ref).abs()  # noqa: E731
                           / (1e-4 + 1e-4 * ref.abs())).max())
    print(f"layer L={l} Cin={cin} Cout={cout} ({case}): max |err| / "
          f"(1e-4 + 1e-4 |ref|): split TF32 {err(got):.3f}, plain TF32 "
          f"{err(one):.3f}; max abs err plain TF32 "
          f"{float((one - ref).abs().max()):.3e}")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("f0", [63.9, 71.0, 200.0, 800.0])
def test_refine_terms_past_the_support_are_zero(f0):
    """The premise of K6's support-only walk: each of _slot_folded's 25
    per-lane terms (x_re, x_im, energy, d_re, d_im; with and without the
    derivative window) is exactly +-0 at every folded lane past
    floor(half_len), so past lane floor(half_len) + 1 too, where the
    kernel stops.  The terms rebuilt here sum to _slot_folded's outputs
    bit for bit (the same tensors through torch.sum), so they are its."""
    fs, w = 16000.0, 768
    rng = np.random.default_rng(int(f0))
    seg = torch.from_numpy(rng.standard_normal((5, w)).astype(np.float32))
    f = torch.full((5, 1), f0) * torch.tensor([[1.0], [1.003], [0.998],
                                               [1.01], [0.99]])
    f = torch.clamp(f, min=harmonics.fold_floor(w, fs))
    e, o = harmonics._fold_eo(seg)
    wh = e.shape[-1]
    b = torch.arange(wh, dtype=torch.float32)[None, :]
    half_len = torch.floor(rdiv(1.5 * fs, f) + 1.0)
    mask = b <= half_len
    phase = (2.0 * np.pi / (3.0 * fs)) * f * b
    cp, sp = torch.cos(phase), torch.sin(phase)
    zero = torch.zeros(())
    win = torch.where(mask, 0.42 + 0.5 * cp + 0.08 * (2.0 * cp * cp - 1.0),
                      zero)
    em, om = torch.where(mask, e, zero), torch.where(mask, o, zero)
    we, wo = em * win, om * win
    col = torch.arange(wh)[None, :]
    edge = (col == 0) | (col >= wh - 1)
    dwin = torch.where(edge, zero, -0.5 * (torch.roll(win, -1, dims=-1)
                                           - torch.roll(win, 1, dims=-1)))
    de, do = em * dwin, om * dwin
    energy = torch.where(b == 0.0, 1.0, 0.5) * (we * we + wo * wo)
    per_harm = [[], [], [], []]            # x_re, x_im, d_re, d_im terms
    for ch, sh in harmonics._recurrence(cp, sp, 6):
        for i, t in enumerate((we * ch, -(wo * sh), do * ch, -(de * sh))):
            per_harm[i].append(t)
    ref = harmonics._slot_folded((e, o), f, fs, 6, True)
    # -sum(v) == sum(-v) bit for bit: rounding to nearest is odd-symmetric
    for terms, r in zip(per_harm, ref[:4]):
        assert torch.equal(torch.stack([torch.sum(t, dim=-1)
                                        for t in terms], dim=-1), r)
    assert torch.equal(torch.sum(energy, dim=-1), ref[4])
    past = b > half_len
    assert bool(past.any(dim=1).all())
    for t in [energy, *sum(per_harm, [])]:
        assert len(t[past]) and bool((t[past] == 0.0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,l,c,s", [(4, 57, 256, 3), (2, 19, 64, 3),
                                       (3, 171, 32, 3)])
def test_d2s_plain_matches_pallas(bsz, l, c, s, dtype):
    """K9 plain == d2s_ln_lrelu (interpret) at the shapes of
    tests/test_ops.py's kernel test.  float32: rtol 2e-4 / atol 2e-5 as
    there.  bfloat16 (gamma and beta rounded to it first in both): the
    float32 math agrees to rounding, which can move the final bfloat16
    rounding by one step, so rtol 8e-3 (one step is at most 2^-7 of the
    value) / atol 1e-5."""
    import jax.numpy as jnp
    from tpuvc.ops.pallas_d2s import d2s_ln_lrelu
    rng = np.random.default_rng(bsz + l + c)
    x = rng.standard_normal((bsz, l, c * s)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    ref = np.asarray(d2s_ln_lrelu(jx, jnp.asarray(g), jnp.asarray(b), s, 0.2,
                                  interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = d2s.d2s_ln_lrelu(tx, torch.from_numpy(g), torch.from_numpy(b), s,
                           0.2)
    assert got.dtype == tx.dtype and got.shape == (bsz, l * s, c)
    tol = (2e-4, 2e-5) if dtype == "float32" else (8e-3, 1e-5)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol[0],
                               atol=tol[1])
    assert _build.read_counts()["d2s"] == 0


@pytest.mark.parametrize("name", ["events", "harmonics", "window", "smooth",
                                  "topk", "refine", "scan", "conv", "d2s"])
def test_wrappers_refuse_wrong_inputs(name):
    """Every wrapper checks dtype and shape before dispatching."""
    x64 = torch.zeros((4, 1024), dtype=torch.float64)
    with pytest.raises(ValueError):
        if name == "events":
            events.event_block_pairs(x64, 20)
        elif name == "harmonics":
            harmonics.harmonic_dft(x64, torch.ones((4, 1)), 16000)
        elif name == "window":
            window.windowed_frames(x64, torch.ones(4), 16000)
        elif name == "topk":
            topk.topk_sum(x64, 21)
        elif name == "refine":
            harmonics.refine_score(x64, torch.ones((4, 10)), 16000, 63.9,
                                   0.2)
        elif name == "scan":
            events.top2_block_scans(torch.zeros((4, 8, 10)))
        elif name == "conv":
            conv.conv_ln_lrelu(torch.zeros((2, 9, 3)), torch.zeros((7, 4, 8)),
                               *torch.zeros((3, 8)), 3, 0.2)
        elif name == "d2s":
            d2s.d2s_ln_lrelu(x64.reshape(4, 8, 128), torch.ones(32),
                             torch.zeros(32), 4, 0.2)
        else:
            smooth.box_smooth(torch.zeros((4, 500)), torch.ones(4), 16000,
                              1024, 810.0)


def test_transfer_snrs_match_the_jax_decoders():
    """The transfer encodings' SNRs (bench.py:243-251: each decoding
    against the int16 codes of the same waveforms) on one set of codes,
    with the port's ulaw8 and pcm12 decoders and with tpuvc.ops.ulaw's:
    equal to 1e-6 dB."""
    from tpuvc.ops import ulaw as jax_ulaw
    from tpuvc_torch.ops import ulaw
    rng = np.random.default_rng(5)
    y = torch.tensor(np.clip(0.3 * rng.standard_normal((2, 1601)), -1, 1),
                     dtype=torch.float32)
    i16 = torch.clamp(y * 32767.0, -32768.0, 32767.0).to(torch.int16)
    u8 = ulaw.ulaw_encode(y).numpy()
    p12 = ulaw.pcm12_encode(y).numpy()
    ref = i16.numpy().astype(np.float32) / 32767.0
    n = ref.shape[-1]

    def snr_db(dec):
        num = float(np.sum(ref * ref))
        return 10.0 * math.log10(
            num / max(float(np.sum((np.asarray(dec) - ref) ** 2)), 1e-20))
    got = [snr_db(ulaw.ulaw_decode(u8)),
           snr_db(ulaw.pcm12_decode(p12, n_samples=n))]
    want = [snr_db(jax_ulaw.ulaw_decode(u8)),
            snr_db(jax_ulaw.pcm12_decode(p12, n_samples=n))]
    assert abs(got[0] - want[0]) < 1e-6 and abs(got[1] - want[1]) < 1e-6
    assert 30.0 < got[0] < 45.0 and got[1] > 55.0


# --- kernels on the card (skip here: no CUDA device) -------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "3-3205x7", "8-3205x7", "20-3205x7", "ties", "20-6000x5", "20-3207x3",
    "32-4100x3", "40-3205x3", "misaligned", "8-3205x2:inf@1000",
    "20-640x2:3e38@100", *[f"{c}/{s}" for c in ("+inf", "-inf", "nan",
                                                 "two-inf") for s in (8, 20)]])
def test_events_kernel_bitexact(cuda, case):
    """Bit-equal, as on the CPU: selections and the same IEEE operations.
    Strides 3, 8, 20 and 32 on the fast path, 40 on the generic one; the
    ties bank; a last tile of 44 blocks in 5 rows (20-6000); an odd T,
    whose rows start off 16-byte alignment (scalar staging), and a
    misaligned base; a tile sent to the generic path by an inf or by a
    finite sample above 2^126 beside tiles on the fast path; and the
    non-finite banks, NaN slots equal to the plain version's."""
    if "/" in case:
        name, stride = case.split("/")
        stride, bank = int(stride), _nonfinite_bank(name)
    else:
        stride, bank = _events_case("20-3204x3" if case == "misaligned"
                                    else case)
    bank = torch.from_numpy(bank)
    ref = events.event_block_pairs_plain(bank, stride)
    n0 = _build.read_counts()["events"]
    dev = bank.to(cuda)
    if case == "misaligned":
        dev = torch.zeros(bank.numel() + 1, device=cuda)
        dev[1:] = bank.reshape(-1).to(cuda)
        dev = dev[1:].view(bank.shape)
        assert dev.data_ptr() % 16
    got = events.event_block_pairs(dev, stride).cpu()
    assert _build.read_counts()["events"] == n0 + 1
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    if not ref.isnan().any():
        assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("with_if", [True, False])
def test_harmonics_kernel_matches_plain(cuda, fold, with_if, k):
    """rtol 1e-4 / atol 1e-4 of the largest output: the warp reduction
    sums in another order than torch.sum.  61 frames (not a multiple of
    the kernel's 8 warps per block), K = 1 and 2 slots, f0 at the fold
    floor, with 6 f0 above Nyquist and 0 (clamped) among the rows."""
    rng = np.random.default_rng(6)
    _, seg = _frames(n=61)
    f0 = rng.uniform(60, 500, (61, k)).astype(np.float32)
    f0[0, 0] = harmonics.fold_floor(1024, 16000.0)
    f0[1, -1] = 1500.0
    f0[2, 0] = 0.0
    f0 = torch.from_numpy(f0)
    ref = harmonics.harmonic_dft_plain(seg, f0, 16000, with_if=with_if,
                                       fold=fold)
    n0 = _build.read_counts()["harmonics"]
    got = harmonics.harmonic_dft(seg.to(cuda), f0.to(cuda), 16000,
                                 with_if=with_if, fold=fold)
    assert _build.read_counts()["harmonics"] == n0 + 1
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-4 * r.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 301])
def test_window_kernel_matches_plain(cuda, n):
    """rtol 1e-5 / atol 1e-6 as on the CPU (reduction order, 1-ulp cosf
    and reciprocal differences).  301 frames (not a multiple of the
    kernel's 8 per block) with f0 from 47 to 900 Hz (below ~94.5 Hz the
    support passes 512 columns: the kernel's two-pass path) and the
    special f0 of _WINDOW_F0 (whole-row supports, the exact half, 900 Hz);
    one frame at each special f0.  One launch per call; rows that are not
    whole float4s are refused."""
    rng = np.random.default_rng(7)
    seg = torch.from_numpy(rng.standard_normal((301, 1024)).astype(
        np.float32))
    f0 = torch.from_numpy(rng.uniform(47, 900, 301).astype(np.float32))
    f0[:len(_WINDOW_F0)] = torch.tensor(_WINDOW_F0)
    cases = ([(seg, f0)] if n == 301 else
             [(seg[i:i + 1], f0[i:i + 1]) for i in range(len(_WINDOW_F0))])
    for s, f in cases:
        ref = window.windowed_frames_plain(s, f, 16000)
        n0 = _build.read_counts()["window"]
        got = window.windowed_frames(s.to(cuda), f.to(cuda), 16000)
        assert _build.read_counts()["window"] == n0 + 1
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=1e-5,
                                       atol=1e-6)
    with pytest.raises(ValueError):      # rows of 1022: not float4 rows
        window.windowed_frames(seg[:2, :1022].contiguous().to(cuda),
                               f0[:2].to(cuda), 16000)


@pytest.mark.gpu
def test_cheaptrick_nonfinite_rows_match_plain(cuda):
    """The window kernel reads only each frame's support, so CheapTrick
    flags the frames that hold a NaN or inf from the waveform: on the card
    the all-NaN rows are the plain version's (a NaN outside one frame's
    support, an inf inside another's), and the finite rows agree within
    rtol 1e-3 (cuFFT against the CPU's FFT, and the kernels' sum order,
    through the log and exp of the lifter)."""
    from tpuvc_torch.dsp.cheaptrick import cheaptrick
    x, f0 = _nonfinite_wave()
    ref = cheaptrick(x, f0)
    got = cheaptrick(x.to(cuda), f0.to(cuda)).cpu()
    nan_rows = torch.isnan(ref).all(-1)
    assert bool(nan_rows.any()) and not bool(nan_rows.all())
    assert torch.equal(torch.isnan(got).all(-1), nan_rows)
    assert not bool(torch.isnan(got[~nan_rows]).any())
    np.testing.assert_allclose(got[~nan_rows].numpy(),
                               ref[~nan_rows].numpy(), rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 301])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("cap", [810.0, 1056.0])
def test_smooth_kernel_matches_plain(cuda, cap, signed, n):
    """Bit-equal (torch.equal): the same weights, the products and sums
    rounded separately and taken in the same order; the kernel skips only
    zero-weight taps.  Both caps (55 and 71 taps), signed spectra (D4C's
    f0/2 site), widths below one bin and above the cap, one frame and a
    frame count that is not a multiple of the kernel's 8 per block."""
    ps, width = _smooth_rows(cap, signed, n=301, seed=8)
    if n == 1:
        ps, width = ps[5:6], width[:1]
    ref = smooth.box_smooth_plain(ps, width, 16000, 1024, cap)
    n0 = _build.read_counts()["smooth"]
    got = smooth.box_smooth(ps.to(cuda), width.to(cuda), 16000, 1024, cap)
    assert _build.read_counts()["smooth"] == n0 + 1
    assert torch.equal(got.cpu(), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [385, 512])
def test_topk_kernel_matches_plain(cuda, c):
    """Bit-equal (the int32 view, so the sign of zero too): the same
    values added in the same order.  _topk_rows (ties, signed zeros,
    all-equal rows, -inf padding) at c = 512 (float4 loads) and 385
    (scalar loads), plus uniform rows to a count that is not a multiple of
    the kernel's 8 per block; at c = 512 also a base that is not 16-byte
    aligned (scalar loads).  One launch per call."""
    rng = np.random.default_rng(c)
    ps = torch.from_numpy(np.concatenate([
        _topk_rows(c), rng.uniform(0, 1, (301, c)).astype(np.float32)]))
    cases = [ps.to(cuda)]
    if c == 512:
        flat = torch.cat([torch.zeros(1), ps.reshape(-1)]).to(cuda)
        cases.append(flat[1:].view(ps.shape))
    for kk in (1, 21, c):
        ref = topk.topk_sum_plain(ps, kk)
        for x in cases:
            n0 = _build.read_counts()["topk"]
            got = topk.topk_sum(x, kk).cpu()
            assert _build.read_counts()["topk"] == n0 + 1
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), kk


@pytest.mark.gpu
@pytest.mark.parametrize("k_slots", [1, 3, 10])
def test_refine_kernel_matches_plain(cuda, k_slots):
    """The warp reductions sum in another order than torch.sum: the CPU
    test's bounds (rtol 1e-5 / atol 1e-4 Hz refined, rtol 1e-4 / atol 1e-5
    score), and the same slots accepted.  _refine_rows' mixed empty and
    rejected slots, plus candidates at the fold floor (62.99 Hz, below the
    63.9 Hz search floor) and at 800 Hz in each of the first three slots;
    1, 3 and 10 slots per frame (one warp each)."""
    seg, f0 = _refine_rows()
    for k in range(3):
        f0[k::13, k] = harmonics.fold_floor(768, 16000.0)
        f0[k + 6::17, k] = 800.0
    seg, f0 = torch.from_numpy(seg), torch.from_numpy(f0[:, :k_slots].copy())
    ref = harmonics.refine_score_plain(seg, f0, 16000, 63.9, 0.2)
    n0 = _build.read_counts()["refine"]
    got = harmonics.refine_score(seg.to(cuda), f0.to(cuda), 16000, 63.9, 0.2)
    assert _build.read_counts()["refine"] == n0 + 1
    r_got, s_got = (v.cpu().numpy() for v in got)
    assert np.array_equal(r_got > 0, ref[0].numpy() > 0)
    np.testing.assert_allclose(r_got, ref[0].numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s_got, ref[1].numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_scan_kernel_bitexact(cuda):
    """Bit-equal to the ladders: selections only.  Several nb, one of
    them past four tiles of the warp's walk, and the adversarial pairs."""
    for nb, seed in ((256, 5), (161, 6), (4000, 7), (1, 8)):
        pairs = torch.from_numpy(_adversarial_pairs(nb, seed, c=37))
        ref = events.top2_block_scans_plain(pairs)
        n0 = _build.read_counts()["scan"]
        got = events.top2_block_scans(pairs.to(cuda)).cpu()
        assert _build.read_counts()["scan"] == n0 + 1
        assert torch.equal(got, ref), nb


@pytest.mark.gpu
@pytest.mark.parametrize("case,n", [("uniform", 301), ("tiny variance", 301),
                                    ("x 1e3", 301), ("uniform", 1)])
@pytest.mark.parametrize("stride,l,cin,cout", [
    (3, 513, 1, 16), (3, 171, 16, 32), (3, 57, 32, 64), (3, 19, 64, 128),
    (3, 7, 128, 256), (1, 19, 8, 16), (3, 57, 8, 64)])
def test_conv_kernel_matches_plain(cuda, stride, l, cin, cout, case, n):
    """The encoder's five layer shapes (layer 1 on the row-per-thread
    route, layers 2-5 on the tensor-core route) and two with Cin = 8 (the
    float32 FMA route) against the plain version with TF32 off: float32
    sums of up to
    K*Cin = 896 products in another order (split TF32 on the tensor
    cores), normalised by the row's deviation; rtol 1e-4 / atol 1e-4.
    _conv_inputs' cases: uniform, rows the norm amplifies ~20x, inputs
    scaled by 1e3; 301 frames (301 * L_out rows: no multiple of any
    route's tile of 64-256 rows) and one frame."""
    x, w, b, g, bt = _conv_inputs(case, n, l, cin, cout)
    ref = conv.conv_ln_lrelu_plain(x, w, b, g, bt, stride, 0.2)
    n0 = _build.read_counts()["conv"]
    got = conv.conv_ln_lrelu(*(t.to(cuda) for t in (x, w, b, g, bt)), stride,
                             0.2).cpu()
    assert _build.read_counts()["conv"] == n0 + 1
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_conv_kernel_on_every_card(cuda):
    """K8's tensor-core route opts in to more than 48 KB of dynamic shared
    memory, an attribute of each device's context: on every visible card,
    first in turn and then from one thread per card (as a serving mesh
    launches), the encoder's layers 2-5 agree with the plain version
    (test_conv_kernel_matches_plain's rtol 1e-4 / atol 1e-4).  Needs two
    cards or more."""
    from tpuvc_torch.parallel import mesh as mesh_lib
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the attribute is per device")
    shapes = [(171, 16, 32), (57, 32, 64), (19, 64, 128), (7, 128, 256)]
    cases = [(_conv_inputs("uniform", 301, l, cin, cout))
             for l, cin, cout in shapes]
    refs = [conv.conv_ln_lrelu_plain(*c, 3, 0.2) for c in cases]

    def on(i, d):
        for c, ref in zip(cases, refs):
            got = conv.conv_ln_lrelu(*(t.to(d) for t in c), 3, 0.2).cpu()
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=str(d))

    mesh = mesh_lib.make_mesh()
    n0 = _build.read_counts()["conv"]
    for i, d in enumerate(mesh.devices):
        on(i, d)
    mesh_lib.run_shards(mesh, on)
    assert _build.read_counts()["conv"] == n0 + 2 * mesh.size * len(shapes)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,c", [(19, 128), (57, 64), (171, 32), (5, 32)])
def test_d2s_kernel_matches_plain(cuda, l, c, dtype):
    """The decoder's three sites (and a short row count) against the
    plain version: float32 rtol 1e-5 / atol 1e-5 (sums in another order);
    bfloat16 one rounding step, rtol 8e-3 / atol 1e-5."""
    rng = np.random.default_rng(c)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((67, l, 3 * c)).astype(
        np.float32)).to(dt)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(
        np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    ref = d2s.d2s_ln_lrelu_plain(x, g, b, 3, 0.2)
    n0 = _build.read_counts()["d2s"]
    got = d2s.d2s_ln_lrelu(x.to(cuda), g.to(cuda), b.to(cuda), 3, 0.2).cpu()
    assert _build.read_counts()["d2s"] == n0 + 1 and got.dtype == dt
    tol = (1e-5, 1e-5) if dtype == "float32" else (8e-3, 1e-5)
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               rtol=tol[0], atol=tol[1])
