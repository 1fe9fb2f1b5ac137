"""The f0 contour's two candidate-extension passes (ops/contour.py).

On the CPU the wrapper takes its plain version, the loop over frames, and
these tests hold it bit for bit against the JAX package's
``_extend_scan`` run forward and then backward over the forward pass's
output (``tpuvc/dsp/dio.py``).  The ``gpu`` tests hold the CUDA kernel
bit for bit against the plain version on every case here and at the
shapes the main path gives it; they skip without a card.

The module imports no JAX at top level, so that the ``gpu`` tests also
run on a machine without it:
``python -m pytest --noconftest tests/test_torch_contour.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from tpuvc_torch.dsp.constants import (DIO_ALLOWED_RANGE,
                                       HARVEST_EXTENSION_ALLOWED)
from tpuvc_torch.ops import _build, contour


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run several worker processes on one machine: PyTorch's
    intra-op threads (one per core in each) would contend with the other
    workers on the small shapes here, so each module runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


f32 = np.float32
KINDS = ("random", "ties", "rounding_ties", "nonfinite", "last_inf",
         "threshold", "unvoiced", "voiced")
# DIO's candidates per frame (channels at the default f0 range) and
# threshold; Harvest's
ALLOWED = {7: DIO_ALLOWED_RANGE, 10: HARVEST_EXTENSION_ALLOWED}
ROWS = 4
# a threshold above 1, where two different numerators can round to one
# error: the candidates then tie, and the lower index must win
ROUNDING_TIE_ALLOWED = 2.0


def _track(rng, b, n, c):
    """Voiced runs of a smooth f0 with unvoiced gaps between them, and per
    frame C candidates: some near the track, some anywhere in 40-800 Hz,
    some 0 (a channel out of range)."""
    t = np.arange(n)
    g = 150.0 + 60.0 * np.sin(2 * np.pi * t / rng.uniform(40, 120, (b, 1))
                              + rng.uniform(0, 6, (b, 1)))
    voiced = np.sin(2 * np.pi * t / rng.uniform(15, 50, (b, 1))
                    + rng.uniform(0, 6, (b, 1))) > rng.uniform(-0.5, 0.5,
                                                              (b, 1))
    f0 = np.where(voiced, g, 0.0).astype(f32)
    cands = g[..., None] * (1.0 + rng.normal(0.0, 0.04, (b, n, c)))
    u = rng.random((b, n, c))
    cands = np.where(u < 0.3, rng.uniform(40, 800, (b, n, c)), cands)
    cands = np.where(u > 0.8, 0.0, cands).astype(f32)
    return f0, cands


def _craft(f0, cands, row, p, last, frame_cands):
    """Frame p voiced at ``last``, frame p + 1 unvoiced with the given
    candidates (the rest of its slots ``fill``): the forward pass decides
    frame p + 1 against exactly ``last``.  No-op where p + 1 is past the
    row."""
    if p + 1 >= f0.shape[1]:
        return
    vals, fill = frame_cands
    f0[row, p], f0[row, p + 1] = last, 0.0
    cands[row, p + 1] = fill
    cands[row, p + 1, :len(vals)] = vals


def _threshold_pair(allowed, side, off):
    """(last, c) in float32 with |c - last| / last exactly the float32
    ``off`` ulps from float32(allowed), c above (side 1) or below (-1)."""
    a = f32(allowed)
    target = (np.array([a]).view(np.int32) + off).view(f32)[0]
    last = (f32(100) + np.arange(20000, dtype=f32) * f32(0.0137)).astype(f32)
    c0 = (last * (f32(1) + f32(side) * a)).astype(f32)
    c = (c0.view(np.int32)[:, None]
         + np.arange(-60, 61, dtype=np.int32)[None]).view(f32)
    q = (np.abs(c - last[:, None]) / last[:, None]).astype(f32)
    i, j = np.argwhere(q == target)[0]
    return last[i], c[i, j]


def _rounding_tie():
    """(last, hi, lo): hi > lo numerators |c - last| whose errors round to
    the same float32, both about 1."""
    last = f32(243.2)
    c = -(np.arange(1, 400, dtype=f32) * f32(2.0 ** -16))
    num = np.abs(c - last).astype(f32)
    q = (num / last).astype(f32)
    j = np.flatnonzero((q[1:] == q[:-1]) & (num[1:] != num[:-1]))[0]
    return last, c[j + 1], c[j]


def case(kind, c, n, seed=0):
    """f0 [ROWS, n], cands [ROWS, n, c] (float32 numpy) and the threshold
    for one kind of input."""
    rng = np.random.default_rng([KINDS.index(kind), c, n, seed])
    allowed = ALLOWED[c]
    f0, cands = _track(rng, ROWS, n, c)
    if kind == "ties":
        # duplicated candidates, and two at the same distance on either
        # side of a power-of-two last (6.25 / 128 is under both thresholds)
        i = rng.integers(0, n, n // 4 + 1)
        cands[:, i, 3] = cands[:, i, 1]
        for row, order in ((0, (134.25, 121.75)), (1, (121.75, 134.25))):
            for p in range(1, n - 1, 37):
                _craft(f0, cands, row, p, 128.0, ((0.0, *order), 0.0))
        for p in range(3, n - 1, 29):
            _craft(f0, cands, 2, p, 128.0, ((130.0, 0.0, 0.0, 130.0), 0.0))
    elif kind == "rounding_ties":
        allowed = ROUNDING_TIE_ALLOWED
        last, hi, lo = _rounding_tie()
        for p in range(1, n - 1, 23):
            _craft(f0, cands, p % ROWS, p, last, ((hi, lo), 10.0 * last))
            _craft(f0, cands, (p + 1) % ROWS, p, last,
                   ((lo, hi), 10.0 * last))
    elif kind == "nonfinite":
        u = rng.random(cands.shape)
        cands[u < 0.08] = np.nan
        cands[(u >= 0.08) & (u < 0.13)] = np.inf
        cands[(u >= 0.13) & (u < 0.18)] = -np.inf
        # a NaN beside a perfect candidate: the frame is rejected
        for p in range(2, n - 1, 31):
            _craft(f0, cands, 0, p, 200.0, ((np.nan, 200.0), 0.0))
            _craft(f0, cands, 1, p, 200.0, ((200.0, np.inf, -np.inf), 0.0))
    elif kind == "last_inf":
        ends = (f0[:, :-1] > 0) & (f0[:, 1:] == 0)
        f0[:, :-1][ends & (rng.random(ends.shape) < 0.7)] = np.inf
        cands[rng.random(cands.shape) < 0.1] = np.inf
    elif kind == "threshold":
        pairs = [_threshold_pair(allowed, side, off)
                 for side in (1, -1) for off in (-1, 0, 1)]
        for k, (last, cv) in enumerate(pairs):
            for p in range(1 + 4 * k, n - 1, 4 * len(pairs)):
                _craft(f0, cands, k % ROWS, p, last, ((cv,), 0.0))
    elif kind == "unvoiced":
        f0[:] = 0.0
    elif kind == "voiced":
        f0 = np.abs(f0) + rng.uniform(60, 400, f0.shape).astype(f32)
    return f0, cands, allowed


def _jax_extend_both(f0, cands, allowed):
    """The JAX package's _extend_scan forward, then backward over its
    output, row by row."""
    import jax
    import jax.numpy as jnp
    from tpuvc.dsp.dio import _extend_scan

    @jax.jit
    def both(f, c):
        g = _extend_scan(f, c, allowed)
        return _extend_scan(g[::-1], c[::-1], allowed)[::-1]

    return np.stack([np.asarray(both(jnp.asarray(f), jnp.asarray(c)))
                     for f, c in zip(f0, cands)])


def _bits(a):
    return np.ascontiguousarray(a, dtype=f32).view(np.uint32)


@pytest.mark.parametrize("n", [1, 201, 1201])
@pytest.mark.parametrize("c", [7, 10])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jax(kind, c, n):
    """The wrapper's CPU route (the plain loop, no launch) equals the JAX
    package's scan run forward then backward, bit for bit: DIO's 7
    candidates at its 0.1 threshold, Harvest's 10 at 0.05, over 1, 201
    (a live tick) and 1201 (a 6 s corpus row) frames."""
    f0, cands, allowed = case(kind, c, n)
    n0 = _build.read_counts()["extend"]
    got = contour.extend_scans(torch.from_numpy(f0),
                               torch.from_numpy(cands), allowed).numpy()
    assert _build.read_counts()["extend"] == n0
    ref = _jax_extend_both(f0, cands, allowed)
    assert np.array_equal(_bits(got), _bits(ref))
    if kind == "unvoiced":
        assert not got.any()
    elif kind == "voiced":
        assert np.array_equal(_bits(got), _bits(f0))
    elif kind in ("ties", "rounding_ties", "threshold") and n > 1:
        # the crafted frames decided both ways
        assert (got[f0 == 0] > 0).any() and (got[f0 == 0] == 0).any()


def test_crafted_cases_hold_what_they_claim():
    """The ties are ties, the rounding tie's numerators differ, and the
    threshold pairs sit at and one ulp either side of float32(allowed)."""
    last, hi, lo = _rounding_tie()
    n_hi, n_lo = (np.abs(np.float32(v) - last) for v in (hi, lo))
    assert n_hi > n_lo and n_hi / last == n_lo / last
    for allowed in ALLOWED.values():
        a = np.array([f32(allowed)]).view(np.int32)[0]
        for side in (1, -1):
            for off in (-1, 0, 1):
                last, cv = _threshold_pair(allowed, side, off)
                q = np.abs(cv - last) / last
                assert q.dtype == f32 and np.array([q]).view(np.int32)[0] \
                    == a + off
    assert (abs(f32(134.25) - f32(128)) / f32(128)
            == abs(f32(121.75) - f32(128)) / f32(128) < f32(0.05))


def _kernel_step(last, f, cv, c, a):
    """One step of csrc/contour.cu's walk for every row at once, in
    float32: the clamp as a select, one division per candidate (lane), the
    lanes past c at +inf, the minimum over the errors' bits as unsigned
    integers and the lowest lane holding it, and a NaN vote beside it."""
    b = last.shape[0]
    d = np.where(last < f32(1e-6), f32(1e-6), last)
    e = np.full((b, 32), np.inf, f32)
    p = np.zeros((b, 32), f32)
    e[:, :c] = np.abs(cv - last[:, None]) / d[:, None]
    p[:, :c] = cv
    nan = np.isnan(e).any(axis=1)
    u = e.view(np.uint32)
    m = u.min(axis=1)
    j = np.argmax(u == m[:, None], axis=1)
    pick = p[np.arange(b), j]
    ok = (f == 0) & (last > 0) & ~nan & (m.view(f32) < f32(a))
    return np.where(f > 0, f, np.where(ok, pick, f32(0)))


def _kernel_rendered(f0, cands, a, tile, producer_first):
    """csrc/contour.cu's schedule over the rows at once: jobs of ``tile``
    frames (forward tiles, then the same tiles backward), warp 1 staging
    job k + 1 in the other buffer while warp 0 walks job k (taken here
    before or after the walk: the kernel gives them no order), the
    backward pass's f0 staged from ``out``, where the forward pass wrote
    it, its first tile after the barrier."""
    b, n, c = cands.shape
    out = np.full((b, n), np.nan, f32)
    nt = -(-n // tile)
    jobs = 2 * nt
    bufs = [(np.full((b, tile), np.nan, f32),
             np.full((b, tile, c), np.nan, f32)) for _ in range(2)]

    def span(k):
        t0 = (k if k < nt else jobs - 1 - k) * tile
        return t0, min(tile, n - t0)

    def stage(k, with_f0, with_cands=True):
        tf, tcb = bufs[k & 1]
        t0, ln = span(k)
        if with_f0:
            tf[:, :ln] = (f0 if k < nt else out)[:, t0:t0 + ln]
        if with_cands:
            tcb[:, :ln] = cands[:, t0:t0 + ln]

    def walk(k, last):
        tf, tcb = bufs[k & 1]
        t0, ln = span(k)
        if k == nt:
            last = np.zeros(b, f32)
        for i in (range(ln) if k < nt else range(ln - 1, -1, -1)):
            last = _kernel_step(last, tf[:, i], tcb[:, i], c, a)
            out[:, t0 + i] = last
        return last

    stage(0, True)
    last = np.zeros(b, f32)
    for k in range(jobs):
        if producer_first and k + 1 < jobs:
            stage(k + 1, k + 1 != nt)
        last = walk(k, last)
        if not producer_first and k + 1 < jobs:
            stage(k + 1, k + 1 != nt)
        if k + 1 == nt:
            stage(nt, True, with_cands=False)
    return out


@pytest.mark.parametrize("c", [7, 10])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_schedule_rendered_matches_plain(kind, c):
    """The kernel's arithmetic and schedule, rendered in numpy, equal the
    plain version bit for bit over 201 frames (a tile of 128 and a ragged
    one), with the staging before or after each walk; and over 1 frame."""
    for n in (201, 1):
        f0, cands, allowed = case(kind, c, n)
        ref = _bits(contour.extend_scans_plain(
            torch.from_numpy(f0), torch.from_numpy(cands), allowed).numpy())
        with np.errstate(invalid="ignore"):
            for producer_first in (True, False):
                got = _kernel_rendered(f0, cands, allowed, 128,
                                       producer_first)
                assert np.array_equal(_bits(got), ref)


@pytest.mark.parametrize("bad", ["f64_cands", "f64_f0", "2d_cands",
                                 "frames_differ", "no_candidates"])
def test_wrapper_refuses_wrong_inputs(bad):
    """dtype and shape are checked before any route is taken."""
    f0 = torch.zeros((2, 5))
    cands = torch.zeros((2, 5, 7))
    if bad == "f64_cands":
        cands = cands.double()
    elif bad == "f64_f0":
        f0 = f0.double()
    elif bad == "2d_cands":
        cands = cands[:, :, 0]
    elif bad == "frames_differ":
        cands = cands[:, :4]
    else:
        cands = cands[:, :, :0]
    with pytest.raises(ValueError):
        contour.extend_scans(f0, cands, 0.1)


# --- the kernel on the card (skips here: no CUDA device) ---------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _on(cands, dev, layout):
    """cands [B, N, C] on dev, contiguous ("bnc", Harvest's) or as the
    transpose of a contiguous [B, C, N] ("bcn", DIO's, which the wrapper
    copies)."""
    t = torch.from_numpy(cands)
    if layout == "bcn":
        return t.transpose(1, 2).contiguous().to(dev).transpose(1, 2)
    return t.to(dev)


def _kernel_equals_plain(f0, cands, allowed, dev, layout):
    ref = contour.extend_scans_plain(torch.from_numpy(f0),
                                     torch.from_numpy(cands), allowed)
    c_dev = _on(cands, dev, layout)
    assert c_dev.is_contiguous() == (layout == "bnc" or cands.shape[1] == 1
                                     or cands.shape[2] == 1)
    n0 = _build.read_counts()["extend"]
    got = contour.extend_scans(torch.from_numpy(f0).to(dev), c_dev, allowed)
    assert _build.read_counts()["extend"] == n0 + 1 and got.device == c_dev.device
    assert np.array_equal(_bits(got.cpu().numpy()), _bits(ref.numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 201, 1201])
@pytest.mark.parametrize("c", [7, 10])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain(cuda, kind, c, n):
    """Every CPU case, bit for bit, DIO's 7 candidates in its layout and
    Harvest's 10 in theirs."""
    f0, cands, allowed = case(kind, c, n)
    _kernel_equals_plain(f0, cands, allowed, cuda,
                         "bcn" if c == 7 else "bnc")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,layout", [
    (64, 1201, 7, "bcn"),      # a corpus request: 64 rows of 6 s, DIO
    (45, 201, 7, "bcn"),       # a live tick: 45 windows of 1 s, DIO
    (64, 6001, 10, "bnc"),     # Harvest over 6 s at 1 ms frames
    (3, 20000, 7, "bcn"),      # a long row: 157 tiles each way
    (5, 300, 17, "bcn"), (5, 300, 32, "bnc"), (5, 129, 1, "bnc")])
def test_kernel_at_main_path_shapes(cuda, b, n, c, layout):
    """The cells' shapes, Harvest's, a long row, and 1, 17 and 32
    candidates."""
    rng = np.random.default_rng([b, n, c])
    f0, cands = _track(rng, b, n, c)
    _kernel_equals_plain(f0, cands, 0.1, cuda, layout)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["dio", "harvest"])
def test_one_launch_per_call(cuda, method, monkeypatch):
    """One launch per DIO or Harvest call on the card, and the call gives
    the same bits as with the plain loop in the kernel's place."""
    from tpuvc_torch.dsp import dio, harvest
    mod = dio if method == "dio" else harvest
    t = np.arange(16000) / 16000.0
    x = np.stack([0.4 * np.sin(2 * np.pi * f * t) * (t < 0.6)
                  + 0.01 * np.random.default_rng(i).standard_normal(t.shape)
                  for i, f in enumerate((130.0, 220.0))]).astype(f32)
    x = torch.from_numpy(x).to(cuda)
    fn = getattr(mod, method)
    n0 = _build.read_counts()["extend"]
    got = fn(x)
    assert _build.read_counts()["extend"] == n0 + 1
    monkeypatch.setattr(mod, "extend_scans", contour.extend_scans_plain)
    ref = fn(x)
    assert _build.read_counts()["extend"] == n0 + 1
    assert (got > 0).any() and torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["too_many", "f0_strided"])
def test_kernel_refuses_what_it_does_not_take(cuda, bad):
    f0 = torch.zeros((2, 9), device=cuda)
    cands = torch.zeros((2, 9, 7), device=cuda)
    if bad == "too_many":
        cands = torch.zeros((2, 9, contour.MAX_CANDS + 1), device=cuda)
    else:
        f0 = torch.zeros((2, 18), device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        contour.extend_scans(f0, cands, 0.1)


@pytest.mark.gpu
def test_kernel_takes_strided_candidates(cuda):
    """Candidates at any strides are copied to [B, N, C] first."""
    f0, cands, allowed = case("random", 7, 201)
    ref = contour.extend_scans_plain(torch.from_numpy(f0),
                                     torch.from_numpy(cands), allowed)
    wide = torch.zeros(cands.shape[:2] + (2 * cands.shape[2],),
                       device=cuda)
    wide[:, :, ::2] = torch.from_numpy(cands).to(cuda)
    got = contour.extend_scans(torch.from_numpy(f0).to(cuda),
                               wide[:, :, ::2], allowed)
    assert np.array_equal(_bits(got.cpu().numpy()), _bits(ref.numpy()))


@pytest.mark.gpu
def test_kernel_on_a_second_card(cuda):
    """A tensor on the second card launches there, while the first card is
    the current one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    f0, cands, allowed = case("random", 7, 201)
    with torch.cuda.device(0):
        _kernel_equals_plain(f0, cands, allowed, torch.device("cuda", 1),
                             "bcn")
