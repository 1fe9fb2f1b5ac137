"""The port's serving-side parallelism (tpuvc_torch.parallel.mesh,
frame_sharding, the ``mesh`` of Converter.convert_batch and
MultiStreamConverter), its thread-safe launch counters and Harvest's
profiler ranges, on the CPU.

The local meshes are virtual: 8 (or 4) x ``cpu``, the counterpart of the
JAX tests' 8-device CPU mesh (tests/conftest.py), so the sharding, the
per-device threads and the gather run for real.  The inputs are
tests/test_parallel.py's; the architectures are small."""

import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import make_harmonic
from tpuvc_torch.dsp.constants import DEFAULT_WORLD
from tpuvc_torch.parallel import mesh as mesh_lib

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the machine: one PyTorch thread
    each (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh8():
    m = mesh_lib.make_mesh(devices=[CPU] * 8)
    assert m.size == 8 and not m.is_process_group
    return m


# --- the mesh --------------------------------------------------------------

@pytest.mark.parametrize("batch_axis", [0, 1])
def test_shard_batch_layout(mesh8, batch_axis):
    """One contiguous shard per device along the batch axis, in order, on
    its device; numpy and tensors alike; several arrays give a tuple."""
    x = np.arange(5 * 16 * 7, dtype=np.float32).reshape(5, 16, 7)
    if batch_axis == 0:
        x = x.reshape(16, 5, 7)
    shards = mesh_lib.shard_batch(mesh8, x, batch_axis=batch_axis)
    assert len(shards) == 8
    for i, s in enumerate(shards):
        assert s.device == CPU and s.shape[batch_axis] == 2
        want = np.take(x, range(2 * i, 2 * i + 2), axis=batch_axis)
        assert np.array_equal(s.numpy(), want)
    xs, ys = mesh_lib.shard_batch(mesh8, torch.from_numpy(x), x,
                                  batch_axis=batch_axis)
    assert all(torch.equal(a, b) for a, b in zip(xs, ys))


def test_mesh_refusals(mesh8):
    """A batch that does not divide raises; so do n_devices above what
    exists, and, without a card, a default (CUDA) mesh."""
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.shard_batch(mesh8, np.zeros((12, 3)))
    with pytest.raises(ValueError, match="requested 9 devices"):
        mesh_lib.make_mesh(9, devices=[CPU] * 8)
    assert mesh_lib.make_mesh(3, devices=[CPU] * 8).size == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh_lib.make_mesh()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh_lib.make_mesh(devices=["cuda:0"])


def test_replicated_shares_a_repeated_device(mesh8):
    """One copy per distinct device: a repeated device shares it, and the
    device that already holds the original gets the original."""
    lin = torch.nn.Linear(3, 2)
    reps = mesh_lib.replicated(mesh8, lin)
    assert len(reps) == 8 and all(r is lin for r in reps)
    t = torch.ones(3)
    assert all(r is t for r in mesh_lib.replicated(mesh8, t))


def test_run_shards_order_threads_and_errors(mesh8):
    """run_shards gives results in shard order from one thread per shard,
    and raises a shard's exception after every shard has finished."""
    seen = set()
    barrier = threading.Barrier(8, timeout=30)

    def fn(i, d):
        barrier.wait()          # all eight run at once, or this times out
        seen.add(threading.get_ident())
        return i * 10

    assert mesh_lib.run_shards(mesh8, fn) == [i * 10 for i in range(8)]
    assert len(seen) == 8
    done = []

    def bad(i, d):
        if i == 3:
            raise KeyError("shard 3")
        done.append(i)

    with pytest.raises(KeyError, match="shard 3"):
        mesh_lib.run_shards(mesh8, bad)
    assert sorted(done) == [0, 1, 2, 4, 5, 6, 7]


def test_launch_counters_are_thread_safe():
    """_build.count under contention: 16 threads x 2000 increments with a
    short switch interval lose none (a bare += would) and touch no other
    kernel's counter."""
    from tpuvc_torch.ops import _build
    _build.reset_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count("events") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert _build.read_counts() == dict(
            dict.fromkeys(_build.KERNEL_NAMES, 0), events=16 * 2000)
    finally:
        sys.setswitchinterval(interval)
        _build.reset_counts()


# --- frame-sharded analysis ------------------------------------------------

@pytest.fixture(scope="module")
def long_signal():
    return make_harmonic(160.0, fs=DEFAULT_WORLD.fs, dur_s=1.0, n_harm=8,
                         noise=0.003).astype(np.float32)


def test_frame_sharded_analysis_matches_unsharded(mesh8, long_signal):
    """analyze_sharded over 8 x cpu against the port's analyze, at
    tests/test_parallel.py's bounds: f0 rtol 1e-4 / atol 1e-3, sp within
    0.1 dB, ap atol 1e-3."""
    from tpuvc_torch.dsp.world import analyze
    from tpuvc_torch.parallel.frame_sharding import analyze_sharded
    ref = analyze(long_signal, DEFAULT_WORLD, device="cpu")
    got = analyze_sharded(long_signal, mesh8, DEFAULT_WORLD)
    np.testing.assert_allclose(got.f0.numpy(), ref.f0.numpy(), rtol=1e-4,
                               atol=1e-3)
    db = lambda v: 10 * np.log10(v.numpy() + 1e-20)  # noqa: E731
    assert np.abs(db(got.sp) - db(ref.sp)).max() < 0.1
    np.testing.assert_allclose(got.ap.numpy(), ref.ap.numpy(), atol=1e-3)


def test_frame_sharded_analysis_matches_jax(mesh8, long_signal):
    """analyze_sharded against tpuvc.parallel.frame_sharding.analyze_sharded
    on conftest's 8-device CPU mesh, within the port-vs-JAX analysis
    bounds of tests/test_torch_dsp.py::test_world_analyze_matches_jax:
    voicing >= 98% equal, voiced f0 within 1e-3 relative, sp within 0.5
    dB, ap within 0.05 dB where neither side is fully aperiodic."""
    from tpuvc.parallel import mesh as jmesh
    from tpuvc.parallel.frame_sharding import analyze_sharded as jax_sharded
    from tpuvc_torch.parallel.frame_sharding import analyze_sharded
    ref = [np.asarray(v) for v in jax_sharded(
        jnp.asarray(long_signal), jmesh.make_mesh())]
    got = [v.numpy() for v in analyze_sharded(long_signal, mesh8)]
    f0g, f0r = got[0], ref[0]
    assert f0g.shape == f0r.shape
    assert np.mean((f0g > 0) == (f0r > 0)) >= 0.98
    both = (f0g > 0) & (f0r > 0)
    assert both.mean() > 0.5
    np.testing.assert_allclose(f0g[both], f0r[both], rtol=1e-3)
    assert np.abs(10 * np.log10(got[1] / ref[1])).max() < 0.5
    full = lambda a: np.all(a >= 1.0 - 1e-6, axis=-1)  # noqa: E731
    rest = ~full(got[2]) & ~full(ref[2])
    assert np.abs(20 * np.log10(got[2][rest] / ref[2][rest])).max() < 0.05


def test_frame_sharding_refuses_a_process_group():
    from tpuvc_torch.parallel.frame_sharding import analyze_sharded
    pg = mesh_lib.DataMesh((CPU,), group=object(), rank=0)
    with pytest.raises(ValueError, match="local mesh"):
        analyze_sharded(np.zeros(1600, np.float32), pg)


# --- data-parallel serving -------------------------------------------------

# tests/test_parallel.py's MultiStream architecture, 10 speakers
SMALL = dict(model="VAE", z_dim=16, y_dim=10, y_emb_dim=8,
             encoder=((7, 7), (3, 3), (8, 16)),
             generator=((7, 7, 7), (3, 3, 3), (16, 8, 1)),
             discriminator=((7,), (3,), (8,)))


def _flax_small():
    """(JAX Converter pieces, port model) from one Flax init."""
    from tpuvc.models.vae import init_params, make_model
    from tpuvc.utils.config import Architecture, NetSpec
    from tpuvc_torch.models import params as port_params
    from tpuvc_torch.utils import config as port_config
    fields = {k: (NetSpec(*v) if isinstance(v, tuple) else v)
              for k, v in SMALL.items()}
    arch = Architecture(**fields)
    model = make_model(arch)
    tree = init_params(model, arch, jax.random.PRNGKey(0))
    parch = port_config.Architecture.from_json(arch.to_json())
    pmodel = port_params.load_model(parch, port_params.from_flax(
        jax.tree_util.tree_map(np.asarray, jax.device_get(tree)), parch),
        device="cpu")
    return model, tree, pmodel


@pytest.fixture(scope="module")
def small():
    return _flax_small()


def _assets(n=10, jax_side=False):
    if jax_side:
        from tpuvc.convert.pipeline import ConverterAssets
    else:
        from tpuvc_torch.convert.pipeline import ConverterAssets
    return ConverterAssets(
        xmin=np.full(513, -10.0, np.float32),
        xmax=np.full(513, 1.0, np.float32),
        f0_mu=np.full(n, 5.0, np.float32), f0_sigma=np.ones(n, np.float32),
        speakers=[f"S{i}" for i in range(n)])


def _requests(n=8, dur_s=0.5):
    xs = [make_harmonic(120.0 + 10 * i, fs=16000, dur_s=dur_s, n_harm=6,
                        noise=0.002, seed=i) for i in range(n)]
    return xs, ["S0"] * n, [f"S{1 + i % 3}" for i in range(n)]


def _port_converter(pmodel, **kw):
    from tpuvc_torch.convert.pipeline import Converter
    return Converter(pmodel, _assets(), DEFAULT_WORLD, device="cpu", **kw)


@pytest.mark.parametrize("case", ["even", "ragged_tail", "budget_split"])
def test_sharded_batch_conversion_matches_single_device(small, case):
    """convert_batch over a virtual CPU mesh against the same Converter
    without one (tests/test_parallel.py's atol 2e-4): 8 requests over 8
    devices; 5 over 4 (one chunk of 4 rows, then one real row padded to
    4: the ragged tail); 8 ragged-length requests over 4 devices with a
    per-device budget of 1 s (chunks of 4 rows of 0.5 s buckets).  The
    replicas are built once per mesh."""
    conv = _port_converter(small[2], bucket_s=0.5)
    xs, srcs, trgs = _requests()
    n_dev, n = {"even": (8, 8), "ragged_tail": (4, 5),
                "budget_split": (4, 8)}[case]
    if case == "budget_split":
        conv.MAX_AUDIO_S_PER_CALL = 1.0
        xs = [x[:int(len(x) * (0.6 + 0.05 * i))] for i, x in enumerate(xs)]
    mesh = mesh_lib.make_mesh(devices=[CPU] * n_dev)
    ref = conv.convert_batch(xs[:n], srcs[:n], trgs[:n], seed=3)
    got = conv.convert_batch(xs[:n], srcs[:n], trgs[:n], seed=3, mesh=mesh)
    reps = conv._replicas
    conv.convert_batch(xs[:2], srcs[:2], trgs[:2], mesh=mesh)
    assert conv._replicas is reps
    assert [len(g) for g in got] == [len(x) for x in xs[:n]]
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b, a, atol=2e-4)


def test_sharded_batch_conversion_matches_jax(small, mesh8, monkeypatch):
    """convert_batch(mesh=8 x cpu) against the JAX Converter's
    convert_batch(mesh=) on conftest's 8-device CPU mesh, from one Flax
    init, the port drawing JAX's synthesis noise: waveform SNR >= 40 dB
    per utterance (the slice's bound, tests/test_torch_pipeline.py)."""
    from tpuvc.convert.pipeline import Converter as JaxConverter
    from tpuvc.parallel import mesh as jmesh
    from tpuvc_torch.convert import pipeline
    from tests.test_torch_cli import jax_noise, snr_db
    model, tree, pmodel = small
    monkeypatch.setattr(pipeline, "synthesis_noise", jax_noise)
    xs, srcs, trgs = _requests()
    jconv = JaxConverter(model, tree, _assets(jax_side=True), DEFAULT_WORLD)
    ref = jconv.convert_batch(xs, srcs, trgs, seed=3,
                              mesh=jmesh.make_mesh())
    got = _port_converter(pmodel).convert_batch(xs, srcs, trgs, seed=3,
                                                mesh=mesh8)
    for a, b in zip(ref, got):
        assert b.shape == a.shape and np.all(np.isfinite(b))
        assert snr_db(a, b) >= 40.0


@pytest.mark.parametrize("n_dev", [4, 8])
def test_multistream_dp_serving_matches_unsharded(small, n_dev):
    """MultiStreamConverter(mesh=) splits each tick's 8 streams over a
    mesh of n_dev x cpu.  With 2 rows per device (4 devices), each stream's
    output matches the unsharded ticks at tests/test_parallel.py's atol
    5e-4 / rtol 1e-3 (measured: equal).  With one row per device (8
    devices), each stream's output is bit-equal to a solo
    StreamingConverter with that stream's seeds (one-row calls too), and
    against the unsharded ticks (batch 8) it keeps the port's batching
    bound, waveform SNR >= 60 dB (tests/test_torch_entry.py::
    test_streaming_resembles_batch_and_multistream_equals_solo): the JAX
    bound does not hold there, with or without a mesh.  PyTorch's CPU rfft
    of one row of 32000 samples (a 2 s bucket) differs from the same row's
    in a batch by ~1e-4 (not at 2 or more rows), and DIO's events turn that
    into 0.26 Hz at the window's hard edge and 0.024 Hz mid-window; 74 of
    35200 samples of a stream then lie beyond the JAX bound, by up to
    2.9e-3, as between one window converted alone and in a batch of 8
    (0.020) without any mesh."""
    from tpuvc_torch.convert.streaming import (MultiStreamConverter,
                                               StreamingConverter)
    x = make_harmonic(150.0, fs=16000, dur_s=2.2, n_harm=8,
                      noise=0.003).astype(np.float32)
    pairs = [("S0", "S1")] * 8
    conv = _port_converter(small[2])

    def run(mesh):
        m = MultiStreamConverter(conv, pairs, chunk_s=1.0, seed=3,
                                 mesh=mesh)
        outs = [[m.push(i, x)] for i in range(len(pairs))]
        for i, tail in enumerate(m.flush_all()):
            outs[i].append(tail)
        return [np.concatenate(o) for o in outs]

    mesh = mesh_lib.make_mesh(devices=[CPU] * n_dev)
    for i, (a, b) in enumerate(zip(run(None), run(mesh))):
        assert a.shape == b.shape
        if n_dev == 4:
            np.testing.assert_allclose(b, a, atol=5e-4, rtol=1e-3)
            continue
        solo = StreamingConverter(conv, *pairs[i], chunk_s=1.0,
                                  seed=3 + 7919 * i)
        np.testing.assert_array_equal(
            b, np.concatenate([solo.push(x), solo.flush()]))
        err = np.sum((b - a).astype(np.float64) ** 2)
        assert 10 * np.log10(np.sum(a.astype(np.float64) ** 2)
                             / max(err, 1e-30)) >= 60.0


def test_serving_refuses_a_process_group_mesh(small):
    """Serving runs over a local mesh: a process-group mesh raises, from
    convert_batch and from a MultiStreamConverter's tick."""
    from tpuvc_torch.convert.streaming import MultiStreamConverter
    pg = mesh_lib.DataMesh((CPU,), group=object(), rank=0)
    conv = _port_converter(small[2])
    xs, srcs, trgs = _requests(2)
    with pytest.raises(ValueError, match="local mesh"):
        conv.convert_batch(xs, srcs, trgs, mesh=pg)
    m = MultiStreamConverter(conv, [("S0", "S1")], chunk_s=0.5, mesh=pg)
    with pytest.raises(ValueError, match="local mesh"):
        m.push(0, np.zeros(16000, np.float32))


# --- Harvest's stage ranges (M15) -----------------------------------------

def test_harvest_profile_shows_its_stage_ranges():
    """A profiled Harvest call on the CPU shows the five ranges named as
    the JAX package's jax.named_scope stages, once each, in order."""
    from torch.profiler import ProfilerActivity, profile
    from tpuvc_torch.dsp.harvest import harvest
    x = torch.from_numpy(make_harmonic(180.0, dur_s=0.2).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        harvest(x[None])
    names = ["hv_band_bank", "hv_event_tracks", "hv_merge", "hv_refine",
             "hv_contour"]
    events = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.name in names)
    assert [n for _, n in events] == names
