"""The port's DSP modules (tpuvc_torch/ops, tpuvc_torch/dsp) against the
JAX package, on the CPU.

Inputs come from a numpy seed or tests/conftest.py's speech-shaped
fixtures (0.5 s); the JAX side runs as its own tests run it off the TPU
(the XLA twins of its kernels).  Each tolerance says why it is what it is.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import make_harmonic, make_speech_like
from tpuvc_torch.dsp import cheaptrick, d4c, dio, filters, harvest, spectral
from tpuvc_torch.dsp import stonemask, synthesis, world
from tpuvc_torch.dsp.constants import WorldConfig
from tpuvc_torch.ops import dft, events, framing, ola

KINDS = ["sweep", "transitions", "breathy"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run several worker processes on one machine: PyTorch's
    intra-op threads (one per core in each) would contend with the other
    workers on the small shapes here, so each module runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _speech(kind):
    x, _, _ = make_speech_like(kind, dur_s=0.5)
    return x.astype(np.float32)


@pytest.mark.parametrize("window,n_frames", [(1024, 101), (2048, 37),
                                             (1024, 7)])
def test_frame_signal_matches_jax(window, n_frames):
    """Framing is a copy: bit-equal to tpuvc.ops.framing.frame_signal."""
    from tpuvc.ops.framing import frame_signal
    x = np.random.default_rng(0).standard_normal(8000).astype(np.float32)
    ref = np.asarray(frame_signal(jnp.asarray(x), 80, window, n_frames))
    got = framing.frame_signal(_t(x)[None], 80, window, n_frames)[0]
    assert np.array_equal(got.numpy(), ref)


def test_dft_identities():
    """The identities of tpuvc/ops/dft.py against float64 numpy FFTs
    (atol 1e-5 of the peak: float32 pocketfft rounding), and against the
    JAX matmul versions (atol 1e-3 of the peak: their float32 matrices
    carry ~1e-4 rad phase error at theta up to ~3e3 rad)."""
    from tpuvc.ops import dft as jdft
    rng = np.random.default_rng(0)
    half, fft = 513, 1024
    x = rng.standard_normal((5, half)).astype(np.float32)
    b = rng.standard_normal((5, half)).astype(np.float32)
    ext = np.concatenate([x, x[:, -2:0:-1]], axis=1).astype(np.float64)

    def close(got, want, jax_val, scale):
        np.testing.assert_allclose(got, want, atol=1e-5 * scale)
        np.testing.assert_allclose(got, np.asarray(jax_val),
                                   atol=1e-3 * scale)

    close(dft.cos_fwd(_t(x)).numpy(), np.fft.rfft(ext).real,
          jdft.cos_fwd(jnp.asarray(x)), np.abs(np.fft.rfft(ext)).max())
    inv = np.fft.irfft(x.astype(np.float64), n=fft)[:, :half]
    close(dft.cos_inv(_t(x)).numpy(), inv, jdft.cos_inv(jnp.asarray(x)),
          np.abs(inv).max())
    inv2 = np.fft.irfft(x + 1j * b, n=fft)[:, :half]
    close(dft.cos_inv2(_t(x), _t(b)).numpy(), inv2,
          jdft.cos_inv2(jnp.asarray(x), jnp.asarray(b)), np.abs(inv2).max())
    seg = rng.standard_normal((5, 80)).astype(np.float32)
    spec = np.fft.rfft(seg.astype(np.float64), n=fft)
    re, im = dft.rdft(_t(seg), fft)
    jre, jim = jdft.rdft(jnp.asarray(seg), fft)
    close(re.numpy(), spec.real, jre, np.abs(spec).max())
    close(im.numpy(), spec.imag, jim, np.abs(spec).max())
    re, im = dft.rdft(_t(seg), fft, 512)      # D4C's band statistic
    jre, jim = jdft.rdft(jnp.asarray(seg), fft, 512)
    close(re.numpy(), spec.real[:, :512], jre, np.abs(spec).max())
    close(im.numpy(), spec.imag[:, :512], jim, np.abs(spec).max())
    np.testing.assert_allclose(
        dft.rdft_power(_t(seg), fft, 512).numpy(),
        np.abs(spec[:, :512]) ** 2, atol=1e-5 * np.abs(spec).max() ** 2)
    full = np.fft.irfft(x + 1j * b, n=fft)
    close(dft.irdft(_t(x), _t(b), fft).numpy(), full,
          jdft.irdft(jnp.asarray(x), jnp.asarray(b), fft), np.abs(full).max())


@pytest.mark.parametrize("n", [8000, 8002])
def test_decimate_matches_jax(n):
    """Both are the same float32 FFT formulation (spectral fold when 4 | n,
    strided read otherwise): atol 1e-5 of the peak, FFT rounding."""
    from tpuvc.dsp.filters import decimate
    x = _speech("sweep")[:n] if n <= 8000 else np.pad(_speech("sweep"),
                                                      (0, n - 8000))
    ref = np.asarray(decimate(jnp.asarray(x), 4))
    got = filters.decimate(_t(x)[None], 4)[0].numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_lowpass_bank_matches_jax():
    """DIO's 7-channel Nuttall bank: same float32 FFT products and phase
    ramp; atol 1e-5 of the peak (FFT rounding)."""
    from tpuvc.dsp.dio import _boundary_f0s
    from tpuvc.dsp.filters import lowpass_bank_fft
    x = np.asarray(jnp.asarray(_speech("sweep")[::4]))
    bounds = _boundary_f0s(71.0, 800.0)
    ref = np.asarray(lowpass_bank_fft(jnp.asarray(x), 4000.0, bounds))
    got = filters.lowpass_bank_fft(_t(x)[None], 4000.0, bounds)[0].numpy()
    assert got.shape == ref.shape == (7, x.shape[0])
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_bandpass_bank_matches_jax():
    """Harvest's 152-channel band-pass bank at 8 kHz: the same float32 FFT
    products, taps and phase ramp; atol 1e-5 of the peak (FFT rounding
    and the 1-ulp cos of the modulation)."""
    from tpuvc.dsp.filters import bandpass_bank_fft
    x = np.asarray(_speech("sweep")[::2])
    bounds = harvest._boundary_f0s(71.0, 800.0)
    assert len(bounds) == 152
    ref = np.asarray(bandpass_bank_fft(jnp.asarray(x), 8000.0, bounds))
    got = filters.bandpass_bank_fft(_t(x)[None], 8000.0, bounds)[0].numpy()
    assert got.shape == ref.shape == (152, x.shape[0])
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_dc_correction_matches_jax():
    """JAX computes the replica with float32 matmul DFTs (~1e-4 rad phase
    error), the port with FFTs: rtol 1e-3 on positive spectra."""
    from tpuvc.dsp.spectral import dc_correction
    rng = np.random.default_rng(2)
    ps = (10.0 ** rng.uniform(-6, 0, (9, 513))).astype(np.float32)
    f0 = rng.uniform(60, 500, 9).astype(np.float32)
    ref = np.asarray(dc_correction(jnp.asarray(ps), jnp.asarray(f0), 16000,
                                   1024))
    got = spectral.dc_correction(_t(ps), _t(f0), 16000, 1024).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3 * ps.max())


def test_interp_and_ola_match_jax():
    """interp_uniform and overlap_add: same float32 arithmetic, rtol 1e-6."""
    from tpuvc.dsp.interp import interp_uniform
    from tpuvc.ops.ola import overlap_add
    from tpuvc_torch.dsp.interp import interp_uniform as port_interp
    rng = np.random.default_rng(3)
    fp = rng.standard_normal((6, 50)).astype(np.float32)
    pos = rng.uniform(-3, 55, (6, 4)).astype(np.float32)
    np.testing.assert_allclose(
        port_interp(_t(fp), _t(pos)).numpy(),
        np.asarray(interp_uniform(jnp.asarray(fp), jnp.asarray(pos))),
        rtol=1e-6)
    frames = rng.standard_normal((11, 1024)).astype(np.float32)
    np.testing.assert_allclose(
        ola.overlap_add(_t(frames)[None], 80)[0].numpy(),
        np.asarray(overlap_add(jnp.asarray(frames), 80)), rtol=1e-6,
        atol=1e-6)


@pytest.fixture(scope="module")
def jax_chain():
    """The JAX analysis of each fixture, computed once per module."""
    from tpuvc.dsp import cheaptrick as jct, d4c as jd4c, dio as jdio
    from tpuvc.dsp import harvest as jhv, stonemask as jsm
    out = {}
    for kind in KINDS:
        x = jnp.asarray(_speech(kind))
        f0c = jdio.dio(x)
        f0 = jsm.stonemask(x, f0c)
        out[kind] = {k: np.array(v) for k, v in dict(
            f0c=f0c, f0=f0, sp=jct.cheaptrick(x, f0),
            ap=jd4c.d4c(x, f0, method="nccf"), ap_gd=jd4c.d4c(x, f0),
            hv=jhv.harvest(x), hv2=jhv.harvest(x, channel_decim=2)).items()}
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_dio_matches_jax(kind, jax_chain):
    """Event times are bit-exact (test_torch_ops); the rest differs only by
    FFT rounding in the decimator and bank.  Voicing agrees on >= 98% of
    frames (a threshold decision may flip under 1e-6 perturbations) and
    voiced frames agree to 1e-3 relative."""
    ref = jax_chain[kind]["f0c"]
    got = dio.dio(_t(_speech(kind))[None])[0].numpy()
    assert got.shape == ref.shape
    vr, vg = ref > 0, got > 0
    assert np.mean(vr == vg) >= 0.98
    both = vr & vg
    assert both.sum() > 0.5 * len(ref)
    np.testing.assert_allclose(got[both], ref[both], rtol=1e-3)


def _speechy_bank(seed, t=3205, rows=4):
    """tests/test_events.py's filtered-channel stand-in at 4 kHz."""
    rng = np.random.default_rng(seed)
    n = np.arange(t) / 4000.0
    return np.stack([(np.sin(2 * np.pi * 170.0 * n)
                      + 0.4 * np.sin(2 * np.pi * 340.0 * n + 0.7)
                      + 0.05 * rng.standard_normal(t)).astype(np.float32)
                     for _ in range(rows)])


@pytest.mark.parametrize("stride", [8, 20])
def test_bank_tracks_fused_scan_matches_jax(stride, monkeypatch):
    """dio._bank_tracks (the fused block scans, K7's route, taken once per
    bank) == the JAX package's with TPUVC_EVENTS=pallas and
    TPUVC_SCAN=pallas (its event and scan kernels in interpret mode), bit
    for bit (np.array_equal): the events and scans are selections and the
    frame reads the same IEEE operations in the same order.  The JAX
    package's default route (its cummax ladders) gives the same bits."""
    from tpuvc.dsp import dio as jdio
    t = 3205
    bank = _speechy_bank(stride + t)
    n_frames = t // stride + 1
    calls = []

    def scans(pairs):
        calls.append(tuple(pairs.shape))
        return events.top2_block_scans(pairs)

    monkeypatch.setattr(dio, "top2_block_scans", scans)
    got = dio._bank_tracks(_t(bank), 4000.0, n_frames, stride).numpy()
    assert len(calls) == 1 and calls[0][:2] == (4, 16)
    monkeypatch.setenv("TPUVC_EVENTS", "pallas")
    monkeypatch.setenv("TPUVC_SCAN", "pallas")
    ref = np.asarray(jdio._bank_tracks(jnp.asarray(bank), 4000.0, n_frames,
                                       stride))
    assert got.shape == ref.shape == (4, 4, n_frames)
    assert np.array_equal(got, ref)
    monkeypatch.setenv("TPUVC_SCAN", "xla")
    ladders = np.asarray(jdio._bank_tracks(jnp.asarray(bank), 4000.0,
                                           n_frames, stride))
    assert np.array_equal(ladders, got)


@pytest.mark.parametrize("kind", KINDS)
def test_stonemask_matches_jax(kind, jax_chain):
    """On the JAX coarse track: rtol 5e-4 / atol 5e-2 Hz, the bound the
    JAX package holds its own kernel twin to (tests/test_ops.py)."""
    c = jax_chain[kind]
    got = stonemask.stonemask(_t(_speech(kind))[None], _t(c["f0c"])[None])
    np.testing.assert_allclose(got[0].numpy(), c["f0"], rtol=5e-4,
                               atol=5e-2)


@pytest.mark.parametrize("kind", KINDS)
def test_cheaptrick_matches_jax(kind, jax_chain):
    """On the JAX f0: within 0.5 dB per bin and 0.05 dB on average.  The
    JAX side's power spectrum, DC correction and lifter are float32
    matmul DFTs (~1e-4 rad matrix phase error); the port's are FFTs.
    Measured: <= 0.12 dB max, <= 0.009 dB mean."""
    c = jax_chain[kind]
    got = cheaptrick.cheaptrick(_t(_speech(kind))[None], _t(c["f0"])[None])
    db = 10.0 * np.log10(got[0].numpy() / c["sp"])
    assert np.abs(db).max() < 0.5
    assert np.abs(db).mean() < 0.05


@pytest.mark.parametrize("kind", KINDS)
def test_d4c_nccf_matches_jax(kind, jax_chain):
    """Both use FFTs here (rfft/irfft): atol 1e-4 on the amplitude ratio
    (measured <= 2e-6)."""
    c = jax_chain[kind]
    got = d4c.d4c(_t(_speech(kind))[None], _t(c["f0"])[None],
                  method="nccf")
    assert got.shape == (1,) + c["ap"].shape
    np.testing.assert_allclose(got[0].numpy(), c["ap"], atol=1e-4)


def test_d4c_group_delay_is_not_ported():
    """The group-delay method is the default (as in the JAX package) and
    runs; an unknown method is refused."""
    x = torch.zeros((1, 8000))
    f0 = torch.zeros((1, 101))
    ap = d4c.d4c(x, f0)
    assert ap.shape == (1, 101, 513) and torch.all(ap > 0.999)
    with pytest.raises(ValueError, match="unknown d4c method"):
        d4c.d4c(x, f0, method="cepstrum")


def _fully_aperiodic(ap):
    return np.all(ap >= 1.0 - 1e-6, axis=-1)


@pytest.mark.parametrize("kind", KINDS)
def test_d4c_group_delay_matches_jax(kind, jax_chain):
    """On the JAX f0: the fully-aperiodic decisions agree on >= 99% of
    frames, and elsewhere ap agrees within 0.05 dB (mean 0.01 dB).  The
    JAX side's six forward transforms are a two-stage Cooley-Tukey matmul
    DFT (rdft_ct) with float32 twiddle matrices; the port's are FFTs,
    the more accurate side.  Measured <= 0.0011 dB max, 1.4e-4 dB mean."""
    c = jax_chain[kind]
    got = d4c.d4c(_t(_speech(kind))[None], _t(c["f0"])[None])[0].numpy()
    ref = c["ap_gd"]
    assert got.shape == ref.shape
    fa_g, fa_r = _fully_aperiodic(got), _fully_aperiodic(ref)
    assert np.mean(fa_g == fa_r) >= 0.99
    rest = ~fa_g & ~fa_r
    db = np.abs(20 * np.log10(got[rest]) - 20 * np.log10(ref[rest]))
    if kind != "transitions":
        assert rest.mean() > 0.9
    assert db.max() < 0.05 and db.mean() < 0.01


@pytest.mark.parametrize("f0_true", [105.0, 235.0])
def test_d4c_group_delay_matches_oracle(f0_true):
    """Against the float64 oracle on its own f0, under the bound
    tests/test_oracle_parity.py::test_d4c_parity holds the JAX package to:
    mean < 0.5 dB, 95th percentile < 2 dB, edge frames excluded."""
    from tests.oracle import oracle_d4c, oracle_dio, oracle_stonemask
    x = make_harmonic(f0_true, fs=16000, dur_s=0.5, n_harm=9, noise=0.002,
                      seed=3)
    f0 = oracle_stonemask(x, oracle_dio(x, 16000), 16000)
    ao = oracle_d4c(x, f0, 16000)
    ap = d4c.d4c(_t(x)[None], _t(f0)[None])[0].numpy().astype(np.float64)
    db = lambda a: 20 * np.log10(np.maximum(a, 1e-8))  # noqa: E731
    d = np.abs(db(ao[5:-5]) - db(ap[5:-5]))
    assert d.mean() < 0.5 and np.percentile(d, 95) < 2.0


@pytest.mark.parametrize("kind,decim", [
    *(pytest.param(k, 1, id=k) for k in KINDS),
    *(pytest.param(k, 2, id=f"{k}-decim2") for k in KINDS)])
def test_harvest_matches_jax(kind, decim, jax_chain):
    """Against the JAX package's CPU route (_refine_and_score; the port
    runs the merged refine_score formulation, equal to reduction-order
    rounding), with WORLD's 1/40-octave bank and the channel_decim=2 fast
    mode (every other channel): voicing agrees on >= 99% of frames,
    voiced f0 within 1e-4 relative.  Measured: voicing 100%, <= 3.4e-6
    relative at decim 1 and <= 3.7e-6 at decim 2."""
    ref = jax_chain[kind]["hv" if decim == 1 else "hv2"]
    got = harvest.harvest(_t(_speech(kind))[None],
                          channel_decim=decim)[0].numpy()
    assert got.shape == ref.shape
    vg, vr = got > 0, ref > 0
    assert np.mean(vg == vr) >= 0.99
    both = vg & vr
    assert both.mean() > 0.5
    np.testing.assert_allclose(got[both], ref[both], rtol=1e-4)


def test_harvest_batch_matches_oracle():
    """A batch of two against the float64 oracle, one utterance at a time,
    under tests/test_oracle_parity.py::test_harvest_parity's bounds:
    voicing >= 95%, voiced f0 within 0.5% mean and 5% max relative, and
    both within 1% median of the truth."""
    from tests.oracle import oracle_harvest
    cases = (105.0, 235.0)
    xs = np.stack([make_harmonic(f, fs=16000, dur_s=0.5, n_harm=9,
                                 noise=0.002, seed=3) for f in cases])
    got = harvest.harvest(_t(xs)).numpy()
    for f0_true, x, dev in zip(cases, xs, got):
        orc = oracle_harvest(x.astype(np.float64), 16000)
        n = min(len(dev), len(orc))
        dev, orc = dev[:n], orc[:n]
        assert np.mean((dev > 0) == (orc > 0)) >= 0.95
        both = (dev > 0) & (orc > 0)
        assert both.sum() > 0.5 * n
        rel = np.abs(dev[both] - orc[both]) / orc[both]
        assert rel.mean() < 0.005 and rel.max() < 0.05
        assert np.median(np.abs(dev[both] - f0_true) / f0_true) < 0.01


def test_harvest_contour_recurrences_match_flat():
    """The blocked jump removal and forward fill equal the flat
    recurrences bit for bit, and the blocked biquad within 1e-5 relative
    (float32 reassociation of the state decomposition), at lengths around
    the block size, two rows at a time (the references of
    tests/test_f0.py::test_blocked_contour_recurrences_match_flat_scans
    and ::test_blocked_fix_step1_matches_flat_scan)."""
    from tpuvc_torch.dsp.constants import (HARVEST_SMOOTH_A1,
                                           HARVEST_SMOOTH_A2,
                                           HARVEST_SMOOTH_B)

    def step1_ref(f0, allowed):
        prev, out = np.float32(0.0), np.empty_like(f0)
        for i, cur in enumerate(f0):
            bad = (cur > 0.0 and prev > 0.0
                   and abs(cur - prev) > allowed * max(cur, 1e-12))
            out[i] = prev = 0.0 if bad else cur
        return out

    def ffill_ref(v, m):
        out, c = np.empty_like(v), v[0]
        for i in range(len(v)):
            c = v[i] if m[i] else c
            out[i] = c
        return out

    def biquad_ref(v):
        (b0, b1, b2), a1, a2 = (HARVEST_SMOOTH_B, HARVEST_SMOOTH_A1,
                                HARVEST_SMOOTH_A2)
        x1 = x2 = y1 = y2 = np.float32(v[0])
        out = np.empty_like(v)
        for i, xi in enumerate(v):
            out[i] = yi = np.float32(b0 * xi + b1 * x1 + b2 * x2
                                     - a1 * y1 - a2 * y2)
            x2, x1, y2, y1 = x1, xi, y1, yi
        return out

    rng = np.random.default_rng(7)
    for n in (5, 127, 128, 129, 1000):
        f0 = rng.uniform(80, 200, (2, n)).astype(np.float32)
        f0 = np.where(rng.random((2, n)) < 0.3, 0.0, f0)
        f0 = np.where(rng.random((2, n)) < 0.15, 2.2 * f0,
                      f0).astype(np.float32)
        m = rng.random((2, n)) < 0.4
        got_s = harvest._fix_step1_scan(_t(f0), 0.03).numpy()
        got_f = harvest._ffill(_t(f0), torch.from_numpy(m)).numpy()
        got_b = harvest._biquad(_t(f0 + 100.0)).numpy()
        for r in range(2):
            assert np.array_equal(got_s[r], step1_ref(f0[r], 0.03)), n
            assert np.array_equal(got_f[r], ffill_ref(f0[r], m[r])), n
            rb = biquad_ref(f0[r] + np.float32(100.0))
            assert (np.abs(got_b[r] - rb) / np.abs(rb)).max() < 1e-5, n


@pytest.mark.parametrize("f0_method,decim", [
    pytest.param("dio", 1, id="dio"), pytest.param("harvest", 1, id="harvest"),
    pytest.param("harvest", 2, id="harvest-decim2")])
def test_world_analyze_matches_jax(f0_method, decim):
    """world.analyze_batch on two 0.5 s utterances and world.analyze on
    each against tpuvc.dsp.world.analyze_batch (DEFAULT_WORLD's D4C;
    Harvest also with harvest_channel_decim=2):
    voicing >= 98% equal and voiced f0 within 1e-3 relative (threshold
    decisions under FFT rounding), sp within 0.5 dB (CheapTrick's matmul
    DFTs on the JAX side, test_cheaptrick_matches_jax), ap within 0.05 dB
    where neither side is fully aperiodic.  The single-utterance entry
    equals the batched one exactly."""
    from tpuvc.dsp import world as jworld
    from tpuvc.dsp.constants import WorldConfig as JaxConfig
    xs = np.stack([_speech(k) for k in ("sweep", "transitions")])
    ref = jworld.analyze_batch(jnp.asarray(xs), JaxConfig(
        f0_method=f0_method, harvest_channel_decim=decim))
    ref = [np.asarray(v) for v in ref]
    cfg = WorldConfig(f0_method=f0_method, harvest_channel_decim=decim)
    got = [v.numpy() for v in world.analyze_batch(xs, cfg, device="cpu")]
    for r in range(2):
        one = world.analyze(xs[r], cfg, device="cpu")
        for g, o in zip(got, one):
            assert np.array_equal(g[r], o.numpy())
    f0g, f0r = got[0], ref[0]
    assert f0g.shape == f0r.shape
    assert np.mean((f0g > 0) == (f0r > 0)) >= 0.98
    both = (f0g > 0) & (f0r > 0)
    np.testing.assert_allclose(f0g[both], f0r[both], rtol=1e-3)
    assert np.abs(10 * np.log10(got[1] / ref[1])).max() < 0.5
    rest = ~_fully_aperiodic(got[2]) & ~_fully_aperiodic(ref[2])
    assert np.abs(20 * np.log10(got[2][rest] / ref[2][rest])).max() < 0.05


def test_world_resynthesize_matches_jax(jax_chain):
    """resynthesize with the JAX noise (made from the seed as the JAX
    package draws it) against tpuvc.dsp.world.resynthesize: SNR >= 50 dB,
    as test_synthesize_matches_jax; with no noise given it draws its own
    from the seed, deterministically."""
    from tpuvc.dsp import world as jworld
    c = jax_chain["sweep"]
    n = c["f0"].shape[0] * 80
    noise = np.array(jax.random.normal(jax.random.PRNGKey(3), (n,),
                                       jnp.float32))
    ref = np.asarray(jworld.resynthesize(jworld.WorldFeatures(
        *(jnp.asarray(c[k]) for k in ("f0", "sp", "ap_gd"))), seed=3))
    feats = world.WorldFeatures(*(_t(c[k]) for k in ("f0", "sp", "ap_gd")))
    got = world.resynthesize(feats, noise=_t(noise)).numpy()
    assert got.shape == ref.shape
    snr = 10 * np.log10(np.sum(ref ** 2) / np.sum((got - ref) ** 2))
    assert snr >= 50.0, snr
    a, b = (world.resynthesize(feats, seed=3) for _ in range(2))
    assert torch.equal(a, b) and torch.isfinite(a).all()


def test_constants_match_jax():
    """The port's copy of tpuvc/dsp/constants.py: every upper-case name of
    either module is in the other with the same value, its functions agree
    on the configurations in use, and WorldConfig has the same fields and
    defaults."""
    import dataclasses
    from tpuvc.dsp import constants as jc
    from tpuvc_torch.dsp import constants as pc

    def upper(mod):
        return {k for k in vars(mod) if k.isupper() and k != "DEFAULT_WORLD"}

    names = upper(pc)
    assert len(names) > 40
    assert "MAX_ANALYSIS_WINDOW" in names      # frame sharding's halo bound
    assert "SYNTH_NOISE_SEED" in names
    assert upper(jc) - names == set() and names - upper(jc) == set()
    for k in sorted(names):
        assert getattr(pc, k) == getattr(jc, k), k
    for fs, floor in ((16000, 71.0), (22050, 50.0), (8000, 100.0)):
        assert pc.harvest_refine_window(fs, floor) == \
            jc.harvest_refine_window(fs, floor)
        assert pc.d4c_fft_size(fs, floor) == jc.d4c_fft_size(fs, floor)
        assert pc.d4c_num_bands(fs) == jc.d4c_num_bands(fs)
    assert pc.max_refined_f0() == jc.max_refined_f0()
    for fs in (8000, 16000, 22050, 44100):
        assert pc.cheaptrick_fft_size(fs) == jc.cheaptrick_fft_size(fs)
        for n in (1024, 2048):
            assert (pc.cheaptrick_f0_floor(fs, n)
                    == jc.cheaptrick_f0_floor(fs, n))
        assert pc.cheaptrick_f0_floor(fs) == jc.cheaptrick_f0_floor(fs)
    assert (dataclasses.asdict(pc.DEFAULT_WORLD)
            == dataclasses.asdict(jc.DEFAULT_WORLD))
    cfg = dict(f0_method="harvest", ap_method="nccf", fs=22050)
    assert (dataclasses.asdict(pc.WorldConfig(**cfg))
            == dataclasses.asdict(jc.WorldConfig(**cfg)))
    assert pc.WorldConfig(fs=22050).hop == jc.WorldConfig(fs=22050).hop


@pytest.mark.parametrize("kind", KINDS)
def test_synthesize_matches_jax(kind, jax_chain):
    """Same features and the same noise (made with jax.random from the
    seed, as the JAX synthesize draws it): waveform SNR >= 50 dB.  The gap
    is float32 rounding in the phase cumsum and the minimum-phase
    transform (JAX matmuls, port FFTs); measured ~78 dB."""
    from tpuvc.dsp.synthesis import synthesize
    c = jax_chain[kind]
    n = c["f0"].shape[0] * 80
    noise = np.array(jax.random.normal(jax.random.PRNGKey(7), (n,),
                                       jnp.float32))
    ref = np.asarray(synthesize(jnp.asarray(c["f0"]), jnp.asarray(c["sp"]),
                                jnp.asarray(c["ap"]), seed=7))
    got = synthesis.synthesize(_t(c["f0"])[None], _t(c["sp"])[None],
                               _t(c["ap"])[None], _t(noise)[None])[0].numpy()
    assert got.shape == ref.shape
    snr = 10 * np.log10(np.sum(ref ** 2) / np.sum((got - ref) ** 2))
    assert snr >= 50.0, snr
