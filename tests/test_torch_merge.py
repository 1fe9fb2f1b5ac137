"""Harvest's channel merge, K12 (ops/merge.py).

On the CPU the wrapper takes its plain version (the channel candidates,
then the loop over the channels), and these tests hold it bit for bit
against the JAX package's ``_channel_candidates`` and ``_merge_channels``
(``tpuvc/dsp/harvest.py``) on random tracks and on crafted ones: more
regions than slots, one run through every channel, no channel proposing,
candidates at the merge tolerance and at every gate's threshold, and
zero, negative, NaN and infinite tracks.  A numpy rendering of
``csrc/merge.cu``'s arithmetic is held against the plain version too.  The
``gpu`` tests hold the CUDA kernel bit for bit against the plain version
on every case here and at the shapes the main path gives it; they skip
without a card.

The module imports no JAX at top level, so that the ``gpu`` tests also
run on a machine without it:
``python -m pytest --noconftest tests/test_torch_merge.py -m gpu``.
"""

import functools

import numpy as np
import pytest
import torch

from tpuvc_torch.dsp.constants import (HARVEST_BAND_GATE_HIGH,
                                       HARVEST_CEIL_ADJUST,
                                       HARVEST_CONSISTENCY,
                                       HARVEST_FLOOR_ADJUST,
                                       HARVEST_MAX_CANDIDATES,
                                       HARVEST_MERGE_TOLERANCE)
from tpuvc_torch.dsp.harvest import _boundary_f0s
from tpuvc_torch.ops import _build, merge


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


f32 = np.float32
K = HARVEST_MAX_CANDIDATES
FLOOR = 71.0 * HARVEST_FLOOR_ADJUST
CEIL = 800.0 * HARVEST_CEIL_ADJUST
KINDS = ("random", "overflow", "one_run", "no_valid", "tolerance", "gates",
         "nonpositive", "nonfinite")
ROWS = 2
# WORLD's 1/40-octave bank at 71-800 Hz, and the decim-2 bank
BANKS = {152: 1, 76: 2}
# bank -> (first value over bf_0, growth a channel; None: the bank's own)
ONE_RUN = {152: (0.986, None), 76: (1.05, 1.029)}


def _bfs(c):
    return np.array(_boundary_f0s(71.0, 800.0)[::BANKS[c]], f32)


def _mean(t):
    """The plain version's mean of the four tracks on axis -2, float32."""
    t = t.astype(f32)
    return (((t[..., 0, :] + t[..., 1, :]) + t[..., 2, :])
            + t[..., 3, :]) / f32(4)


def _ulps(x, k):
    """float32 x moved k ulps (x > 0)."""
    return (np.array([x], f32).view(np.int32) + k).view(f32)[0]


def _quad_with_mean(target):
    """Four float32 tracks within a few ulps of ``target`` whose mean, as
    the plain version sums it, is exactly ``target``."""
    off = np.arange(-6, 7)
    x = (np.array([target], f32).view(np.int32) + off).view(f32)
    q = np.stack(np.broadcast_arrays(x[:, None], x[:, None], x[None, :],
                                     x[None, :]), axis=-1)   # [13, 13, 4]
    m = _mean(q[..., None])[..., 0]
    i, j = np.argwhere(m == f32(target))[0]
    return q[i, j]


def _dev_quad(at):
    """Four float32 tracks (b - d, b + d/2, b, b) whose deviation, as the
    plain version computes it, is float32(HARVEST_CONSISTENCY) moved
    ``at`` ulps: d = 0.2 b / 0.9, searched ulp by ulp; b from 120."""
    target = _ulps(f32(HARVEST_CONSISTENCY), at)
    for base in f32(120.0) + np.arange(200, dtype=f32) * f32(0.37):
        d = (np.array([f32(base * 0.2 / 0.9)], f32).view(np.int32)
             + np.arange(-3000, 3001, dtype=np.int32)).view(f32)
        t = np.stack(np.broadcast_arrays(base - d, base + d * f32(0.5),
                                         np.full_like(d, base),
                                         np.full_like(d, base)), axis=-1)
        m = _mean(t[..., None])[..., 0]
        dev = (np.max(np.abs(t - m[:, None]), axis=-1)
               / np.maximum(m, f32(1e-12))).astype(f32)
        hit = np.flatnonzero(dev == target)
        if hit.size:
            return t[hit[0]]
    raise AssertionError("no deviation quad found")


def _tolerance_pair(at):
    """(p, c): c above p with |c - p| against the float32 tolerance
    tol * p decided ``at`` ulps from equality (0: equal, so the two do not
    merge; -1: just inside, they merge; +1: just outside)."""
    tol = f32(HARVEST_MERGE_TOLERANCE)
    for p in f32(100.0) + np.arange(5000, dtype=f32) * f32(0.0173):
        lim = (tol * p).astype(f32)
        c0 = (p + lim).astype(f32)
        cs = (np.array([c0], f32).view(np.int32)
              + np.arange(-8, 9)).view(f32)
        diff = np.abs(cs - p).astype(f32)
        want = _ulps(lim, at)
        hit = np.flatnonzero(diff == want)
        if hit.size:
            return p, cs[hit[0]]
    raise AssertionError("no tolerance pair found")


def _random_tracks(rng, b, c, n):
    """A true f0 per frame, the channels of its band reporting it with a
    few percent of noise (sometimes), the rest anything in 20-1200 Hz, or
    a consistent stray value, or nothing."""
    bfs = _bfs(c)
    f0 = rng.uniform(60.0, 900.0, (b, 1, 1, n))
    near = f0 * (1.0 + rng.normal(0.0, 0.03, (b, c, 4, n)))
    stray = rng.uniform(40.0, 900.0, (b, c, 1, n)) * (
        1.0 + rng.normal(0.0, 0.01, (b, c, 4, n)))
    anything = rng.uniform(20.0, 1200.0, (b, c, 4, n))
    u = rng.random((b, c, 1, n))
    in_band = ((f0 >= bfs[:, None, None] / 2)
               & (f0 <= bfs[:, None, None] * 1.1))
    t = np.where(in_band & (u < 0.8), near,
                 np.where(u < 0.3, stray, anything))
    return np.where(u > 0.95, 0.0, t).astype(f32)


def case(kind, c, n, seed=0):
    """tracks [ROWS, c, 4, n] float32 for one kind of input, bfs [c], and
    the crafted frames' expected region counts: {(row, frame): count}."""
    rng = np.random.default_rng([KINDS.index(kind), c, n, seed])
    bfs = _bfs(c)
    t = _random_tracks(rng, ROWS, c, n)
    expect = {}
    frames = list(range(0, n, 2))

    def put(row, frame, chans, quads, count):
        """frame's channels all silent but ``chans``, which get ``quads``."""
        t[row, :, :, frame] = 0.0
        for ch, q in zip(chans, quads):
            t[row, ch, :, frame] = q
        expect[(row, frame)] = count

    if kind == "overflow":
        # every other channel proposes a value inside its own band, so no
        # two neighbours merge: c/2 regions, of which the first K emit
        for f in frames:
            chans = range(f % 2, c, 2)
            put(f % ROWS, f, chans,
                [np.full(4, bfs[ch] * f32(0.75), f32) for ch in chans],
                min(len(chans), K))
    elif kind == "one_run":
        # each channel's value r bf_0 g^i, with g the bank's spacing (1/40
        # octave, under the tolerance) or, on the decim-2 bank, just under
        # the tolerance: every channel passes its gates, one region through
        # all of them
        r, g = ONE_RUN[c]
        vals = (bfs[0] * r * (g or float(bfs[1] / bfs[0])) ** np.arange(c)
                ).astype(f32)
        for f in frames:
            put(f % ROWS, f, range(c), [np.full(4, v, f32) for v in vals], 1)
    elif kind == "no_valid":
        # every channel's four tracks disagree, or are silent
        t[...] = rng.uniform(20.0, 1200.0, t.shape).astype(f32)
        t[:, :, 1] = t[:, :, 0] * f32(2.0)     # deviation 0.25 or more
        t[:, ::3] = 0.0
        expect.update({(r, f): 0 for r in range(ROWS) for f in range(n)})
    elif kind == "tolerance":
        ch = c // 3
        for k, (at, count) in enumerate(((0, 2), (-1, 1), (1, 2))):
            p, cv = _tolerance_pair(at)
            for f in frames[k::3]:
                put(f % ROWS, f, (ch, ch + 1),
                    (_quad_with_mean(p), _quad_with_mean(cv)), count)
    elif kind == "gates":
        k = c // 3
        floor, ceil = f32(FLOOR), f32(CEIL)
        lo, hi = bfs[k] * f32(0.5), bfs[k] * f32(HARVEST_BAND_GATE_HIGH)
        gates = [  # channel, tracks, proposes
            (0, _quad_with_mean(floor), 1),
            (0, _quad_with_mean(_ulps(floor, -1)), 0),
            (c - 1, _quad_with_mean(ceil), 1),
            (c - 1, _quad_with_mean(_ulps(ceil, 1)), 0),
            (k, _quad_with_mean(lo), 1),
            (k, _quad_with_mean(_ulps(lo, -1)), 0),
            (k, _quad_with_mean(hi), 1),
            (k, _quad_with_mean(_ulps(hi, 1)), 0),
            (k, _dev_quad(0), 1), (k, _dev_quad(1), 0),
            (k, _dev_quad(-1), 1)]
        for i, f in enumerate(frames):
            ch, q, count = gates[i % len(gates)]
            put(f % ROWS, f, (ch,), (q,), count)
    elif kind == "nonpositive":
        bad = [np.array(q, f32) for q in (
            (0.0, 200.0, 200.0, 200.0), (200.0, -200.0, 200.0, 200.0),
            (-200.0, -200.0, -200.0, -200.0), (-0.0, -0.0, -0.0, -0.0),
            (0.0, 0.0, 0.0, 0.0))]
        u = rng.integers(0, len(bad) + 1, (ROWS, c, n))
        for i, q in enumerate(bad):
            r, ch, f = np.nonzero(u == i)
            t[r, ch, :, f] = q
        for i, f in enumerate(frames):
            put(f % ROWS, f, (c // 2,), (bad[i % len(bad)],), 0)
    elif kind == "nonfinite":
        bad = [np.array(q, f32) for q in (
            (np.nan, 200.0, 200.0, 200.0), (200.0, np.inf, 200.0, 200.0),
            (np.inf,) * 4, (-np.inf, 200.0, 200.0, 200.0),
            (3e38, 3e38, 3e38, 3e38), (np.nan,) * 4)]
        u = rng.integers(0, 2 * len(bad), (ROWS, c, n))
        for i, q in enumerate(bad):
            r, ch, f = np.nonzero(u == i)
            t[r, ch, :, f] = q
        for i, f in enumerate(frames):
            put(f % ROWS, f, (c - 1,), (bad[i % len(bad)],), 0)
    return t, bfs, expect


@functools.lru_cache(maxsize=None)
def _jax_merge():
    import jax
    from tpuvc.dsp.harvest import _channel_candidates, _merge_channels
    return jax.jit(lambda t, b: _merge_channels(
        *_channel_candidates(t, b, FLOOR, CEIL)))


def _jax(tracks, bfs):
    """The JAX package's candidates and merge, row by row: (values,
    deviations) [B, N, K]."""
    import jax.numpy as jnp
    out = [_jax_merge()(jnp.asarray(t), jnp.asarray(bfs)) for t in tracks]
    return tuple(np.stack([np.asarray(o[i]) for o in out]) for i in (0, 1))


def _bits(a):
    return np.ascontiguousarray(a, dtype=f32).view(np.uint32)


def _regions(v):
    return (v > 0).sum(-1)


@pytest.mark.parametrize("n", [1, 37, 300])
@pytest.mark.parametrize("c", sorted(BANKS))
@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jax(kind, c, n):
    """The wrapper's CPU route (the plain version, no launch) equals the
    JAX package's candidates and merge bit for bit, values and (through
    ``merge_runs``) deviations, on both banks; the crafted frames come out
    as crafted."""
    tracks, bfs, expect = case(kind, c, n)
    t, b = torch.from_numpy(tracks), torch.from_numpy(bfs)
    n0 = _build.read_counts()["merge"]
    got = merge.merge_channels(t, b, FLOOR, CEIL).numpy()
    assert _build.read_counts()["merge"] == n0
    with np.errstate(invalid="ignore", over="ignore"):
        ref_v, ref_d = _jax(tracks, bfs)
    assert got.shape == (ROWS, n, K)
    assert np.array_equal(_bits(got), _bits(ref_v))
    _, dev = merge.merge_runs(*merge.channel_candidates(t, b, FLOOR, CEIL))
    assert np.array_equal(_bits(dev.numpy()), _bits(ref_d))
    regions = _regions(got)
    for (row, frame), count in expect.items():
        assert regions[row, frame] == count, (row, frame)
    if kind == "random" and n > 1:
        assert regions.max() == K and (regions < K).any()


def _kernel_rendered(tracks, bfs, floor, ceil):
    """csrc/merge.cu's arithmetic in numpy, every (row, frame) at once:
    each channel's mean summed left to right, times 0.25; fmaxf (a NaN
    loses) for the deviation's maximum and both clamps; the gates and the
    merge; the K slots written by predicated selects in registers."""
    b, c, _, n = tracks.shape
    g_cons, g_high = f32(HARVEST_CONSISTENCY), f32(HARVEST_BAND_GATE_HIGH)
    tol, fl, ce = f32(HARVEST_MERGE_TOLERANCE), f32(floor), f32(ceil)
    v = np.zeros((K, b, n), f32)
    filled = np.zeros((b, n), np.int32)
    run_sum = np.zeros((b, n), f32)
    run_cnt = np.zeros((b, n), f32)
    prev = np.zeros((b, n), f32)

    def emit(value, on):
        nonlocal filled
        can = on & (filled < K)
        for k in range(K):
            v[k] = np.where(can & (filled == k), value, v[k])
        filled = filled + can

    for ch in range(c):
        t0, t1, t2, t3 = (tracks[:, ch, j] for j in range(4))
        mean = (((t0 + t1) + t2) + t3) * f32(0.25)
        d = np.fmax(np.fmax(np.abs(t0 - mean), np.abs(t1 - mean)),
                    np.fmax(np.abs(t2 - mean), np.abs(t3 - mean)))
        dev = d / np.fmax(mean, f32(1e-12))
        bf = bfs[ch]
        ok = ((t0 > 0) & (t1 > 0) & (t2 > 0) & (t3 > 0) & (dev <= g_cons)
              & (mean >= fl) & (mean <= ce) & (mean >= bf * f32(0.5))
              & (mean <= bf * g_high))
        ci = np.where(ok, mean, f32(0))
        valid = ci > 0
        cont = valid & (prev > 0) & (np.abs(ci - prev)
                                     < tol * np.fmax(prev, f32(1e-12)))
        emit(run_sum / np.fmax(run_cnt, f32(1)), (run_cnt > 0) & ~cont)
        run_sum = np.where(cont, run_sum + ci, np.where(valid, ci, f32(0)))
        run_cnt = np.where(cont, run_cnt + f32(1),
                           np.where(valid, f32(1), f32(0)))
        prev = ci
    emit(run_sum / np.fmax(run_cnt, f32(1)), run_cnt > 0)
    return np.moveaxis(v, 0, -1)


@pytest.mark.parametrize("c", sorted(BANKS))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_arithmetic_rendered_matches_plain(kind, c):
    """The kernel's arithmetic, rendered in numpy float32, equals the plain
    version bit for bit, NaN and infinite tracks included (fmaxf and the
    plain version's amax and clamp part only where a gate is already
    failed)."""
    for n in (37, 1):
        tracks, bfs, _ = case(kind, c, n, seed=1)
        ref = merge.merge_channels_plain(torch.from_numpy(tracks),
                                         torch.from_numpy(bfs), FLOOR, CEIL)
        with np.errstate(invalid="ignore", over="ignore"):
            got = _kernel_rendered(tracks, bfs, FLOOR, CEIL)
        assert np.array_equal(_bits(got), _bits(ref.numpy()))


def test_crafted_cases_hold_what_they_claim():
    """The tolerance pairs sit at and one ulp either side of the float32
    tolerance, the gate quads' means and deviations at their thresholds."""
    tol = f32(HARVEST_MERGE_TOLERANCE)
    for at in (-1, 0, 1):
        p, cv = _tolerance_pair(at)
        assert abs(cv - p) == _ulps((tol * p).astype(f32), at)
    for target in (f32(FLOOR), f32(CEIL), f32(123.456)):
        q = _quad_with_mean(target)
        assert _mean(q[:, None])[0] == target
    for at in (-1, 0, 1):
        q = _dev_quad(at)
        m = _mean(q[:, None])[0]
        assert np.max(np.abs(q - m)) / m == _ulps(f32(HARVEST_CONSISTENCY),
                                                  at)


@pytest.mark.parametrize("bad", ["f64", "rank3", "three_tracks",
                                 "channels_differ", "bfs_f64", "bfs_2d",
                                 "strided"])
def test_wrapper_refuses_wrong_inputs(bad):
    """dtype, rank, channel count and contiguity are checked before any
    route is taken."""
    tracks = torch.zeros((2, 6, 4, 5))
    bfs = torch.from_numpy(_bfs(152)[:6])
    if bad == "f64":
        tracks = tracks.double()
    elif bad == "rank3":
        tracks = tracks[0]
    elif bad == "three_tracks":
        tracks = tracks[:, :, :3]
    elif bad == "channels_differ":
        bfs = bfs[:5]
    elif bad == "bfs_f64":
        bfs = bfs.double()
    elif bad == "bfs_2d":
        bfs = bfs[None]
    else:
        tracks = torch.zeros((2, 6, 4, 10))[..., ::2]
    with pytest.raises(ValueError):
        merge.merge_channels(tracks, bfs, FLOOR, CEIL)


# --- the kernel on the card (skips here: no CUDA device) ---------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_equals_plain(tracks, bfs, dev):
    """The kernel on ``dev`` against the plain version run on the same
    device (bit-equal to its CPU run: the same IEEE operations)."""
    n0 = _build.read_counts()["merge"]
    got = merge.merge_channels(tracks.to(dev), bfs.to(dev), FLOOR, CEIL)
    assert _build.read_counts()["merge"] == n0 + 1
    assert got.device == tracks.to(dev).device
    ref = merge.merge_channels_plain(tracks.to(dev), bfs.to(dev), FLOOR,
                                     CEIL)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 37, 300])
@pytest.mark.parametrize("c", sorted(BANKS))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain(cuda, kind, c, n):
    """Every CPU case, bit for bit, and against the plain version's CPU
    run too."""
    tracks, bfs, _ = case(kind, c, n)
    t, b = torch.from_numpy(tracks), torch.from_numpy(bfs)
    got = _kernel_equals_plain(t, b, cuda)
    cpu = merge.merge_channels_plain(t, b, FLOOR, CEIL)
    assert np.array_equal(_bits(got.cpu().numpy()), _bits(cpu.numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,n", [
    (64, 152, 6001),        # a Harvest corpus request: 64 rows of 6 s
    (64, 76, 6001),         # the same on the decim-2 bank
    (3, 152, 1001),         # 3003 (row, frame) threads: a ragged block
    (5, 76, 129), (1, 1, 1)])
def test_kernel_at_main_path_shapes(cuda, b, c, n):
    """The cell's shape, decim 2's, a ragged count of frames and one
    channel, on random tracks made on the card."""
    gen = torch.Generator(device=cuda).manual_seed(b * c + n)
    f0 = 60.0 + 840.0 * torch.rand((b, 1, 1, n), generator=gen,
                                   device=cuda)
    noise = 1.0 + 0.03 * torch.randn((b, c, 4, n), generator=gen,
                                     device=cuda)
    anything = 20.0 + 1180.0 * torch.rand((b, c, 4, n), generator=gen,
                                          device=cuda)
    pick = torch.rand((b, c, 1, n), generator=gen, device=cuda) < 0.5
    tracks = torch.where(pick, f0 * noise, anything).contiguous()
    bfs = torch.from_numpy(_bfs(152 if c == 152 else 76)[:c])
    got = _kernel_equals_plain(tracks, bfs, cuda)
    assert (got > 0).any() or c == 1


@pytest.mark.gpu
@pytest.mark.parametrize("decim", [1, 2])
def test_one_launch_per_call(cuda, decim, monkeypatch):
    """One launch per Harvest call on the card, on either bank, and the
    call gives the same bits as with the plain version in the kernel's
    place."""
    from tpuvc_torch.dsp import harvest
    t = np.arange(16000) / 16000.0
    x = np.stack([0.4 * np.sin(2 * np.pi * f * t) * (t < 0.6)
                  + 0.01 * np.random.default_rng(i).standard_normal(t.shape)
                  for i, f in enumerate((130.0, 220.0))]).astype(f32)
    x = torch.from_numpy(x).to(cuda)
    n0 = _build.read_counts()["merge"]
    got = harvest.harvest(x, channel_decim=decim)
    assert _build.read_counts()["merge"] == n0 + 1
    monkeypatch.setattr(harvest, "merge_channels",
                        merge.merge_channels_plain)
    ref = harvest.harvest(x, channel_decim=decim)
    assert _build.read_counts()["merge"] == n0 + 1
    assert (got > 0).any() and torch.equal(got, ref)


@pytest.mark.gpu
def test_kernel_refuses_bfs_elsewhere(cuda):
    tracks = torch.zeros((2, 6, 4, 5), device=cuda)
    with pytest.raises(ValueError):
        merge.merge_channels(tracks, torch.from_numpy(_bfs(152)[:6]),
                             FLOOR, CEIL)


@pytest.mark.gpu
def test_kernel_on_a_second_card(cuda):
    """A tensor on the second card launches there, while the first card is
    the current one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    tracks, bfs, _ = case("random", 152, 300)
    with torch.cuda.device(0):
        _kernel_equals_plain(torch.from_numpy(tracks),
                             torch.from_numpy(bfs), torch.device("cuda", 1))
