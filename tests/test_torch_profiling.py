"""The port's stage spans (``tpuvc_torch.utils.profiling.span``) and the
converter's padding counters, on the CPU: a span enters nothing without
a profiler; under one, a conversion, a streaming tick and a VAW-GAN step
leave each of their stages' ranges once, nested in its parent by interval
containment."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.conftest import make_speech_like
from tpuvc_torch.dsp.constants import DEFAULT_WORLD, WorldConfig
from tpuvc_torch.utils import config as port_config
from tpuvc_torch.utils import profiling

# a conversion's stages: each inside its call's ``vc.convert_batch``, once
# per chunk
CHUNK_SPANS = ("vc.prep", "vc.upload", "vc.noise", "world.f0", "world.sp",
               "world.ap", "vc.model", "vc.encode", "vc.decode", "vc.synth",
               "vc.fetch")
F0_SPANS = {"dio": ("dio_bank", "dio_contour", "stonemask"),
            "harvest": ("hv_band_bank", "hv_event_tracks", "hv_merge",
                        "hv_refine", "hv_contour")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the machine: one PyTorch thread
    each (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ranges(prof) -> dict[str, list[tuple[int, int]]]:
    """The trace's host ranges by name, each (start, end) in us."""
    out: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CPU:
            out.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    return out


def _inside(ranges, child: str, parent: str) -> bool:
    """Every ``child`` range lies inside some ``parent`` range."""
    return all(any(ps <= cs and ce <= pe for ps, pe in ranges[parent])
               for cs, ce in ranges[child])


def _converter(cfg: WorldConfig, bucket_s: float = 0.25,
               budget_s: float | None = None):
    from tpuvc_torch.convert import pipeline
    from tpuvc_torch.models import params
    arch = port_config.Architecture(y_dim=3)
    model = params.load_model(arch, params.init_params(
        arch, torch.Generator().manual_seed(0), device="cpu"), device="cpu")
    assets = pipeline.ConverterAssets(
        xmin=np.full(513, -10.0, np.float32),
        xmax=np.full(513, 1.0, np.float32),
        f0_mu=np.array([5.0, 5.3, 5.1], np.float32),
        f0_sigma=np.ones(3, np.float32), speakers=["A", "B", "C"])
    conv = pipeline.Converter(model, assets, cfg, bucket_s=bucket_s,
                              transfer_encoding="ulaw8", device="cpu")
    if budget_s is not None:
        conv.MAX_AUDIO_S_PER_CALL = budget_s
    return conv


def _speech(*durations):
    kinds = ("sweep", "vibrato", "sweep")
    return [make_speech_like(kinds[i % 3], dur_s=d, seed=i)[0]
            .astype(np.float32) for i, d in enumerate(durations)]


def test_a_span_without_a_profiler_enters_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    s = profiling.span("vc.prep")
    assert s is profiling.NULL_SPAN and profiling.span("x") is s
    with s:
        with profiling.span("nested"):
            pass


def test_a_span_under_a_profiler_is_a_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
    r = _ranges(prof)
    assert len(r["outer"]) == len(r["inner"]) == 1
    assert _inside(r, "inner", "outer")
    assert profiling.span("after") is profiling.NULL_SPAN


@pytest.mark.parametrize("f0_method", ["dio", "harvest"])
def test_a_conversion_leaves_its_stage_tree_once_per_chunk(f0_method):
    """Three utterances under a budget of two rows a call: two chunks
    (the second pads to two rows), each with every stage once, the f0
    method's own stages inside ``world.f0``."""
    cfg = WorldConfig(f0_method=f0_method, ap_method=DEFAULT_WORLD.ap_method)
    conv = _converter(cfg, bucket_s=0.25, budget_s=0.5)
    xs = _speech(0.2, 0.25, 0.15)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ys = conv.convert_batch(xs, ["A", "B", "C"], ["B", "C", "A"], seed=3)
    assert [len(y) for y in ys] == [len(x) for x in xs]
    r = _ranges(prof)
    assert len(r["vc.convert_batch"]) == 1
    for name in CHUNK_SPANS:
        assert len(r[name]) == 2, name
        assert _inside(r, name, "vc.convert_batch"), name
    for name in F0_SPANS[f0_method]:
        assert len(r[name]) == 2, name
        assert _inside(r, name, "world.f0"), name
    for name in ("vc.encode", "vc.decode"):
        assert _inside(r, name, "vc.model"), name
    other = "harvest" if f0_method == "dio" else "dio"
    assert not set(F0_SPANS[other]) & set(r)


def test_the_padding_counters_are_exact_for_a_ragged_batch():
    """Lengths 1000, 5000 and 3000 samples in 0.25 s buckets pad to 8000;
    a budget of two such rows splits them into two chunks of two rows, the
    second repeating its last row: 9000 real samples, 4 x 8000 analysed."""
    from tpuvc_torch.convert import pipeline
    conv = _converter(DEFAULT_WORLD, bucket_s=0.25, budget_s=1.0)
    xs = [x[:n] for x, n in zip(_speech(0.1, 0.35, 0.2),
                                (1000, 5000, 3000))]
    pipeline.samples_real = pipeline.samples_analysed = 0
    ys = conv.convert_batch(xs, ["A", "B", "C"], ["C", "A", "B"], seed=1)
    assert [len(y) for y in ys] == [1000, 5000, 3000]
    assert pipeline.samples_real == 9000
    assert pipeline.samples_analysed == 4 * 8000
    conv.convert_batch(xs[:1], ["A"], ["B"])       # they add up
    assert pipeline.samples_real == 10000
    assert pipeline.samples_analysed == 4 * 8000 + 4000


def test_a_streaming_tick_nests_inside_the_last_push():
    """Three streams each push one full window: three ``vc.push``, the
    last holding the one ``vc.tick``, which holds the rows' gathering, the
    batched call and the crossfades."""
    from tpuvc_torch.convert.streaming import MultiStreamConverter
    conv = _converter(DEFAULT_WORLD, bucket_s=0.5)
    multi = MultiStreamConverter(conv, [("A", "B"), ("B", "C"), ("C", "A")],
                                 chunk_s=0.05, halo_s=0.128, seed=7)
    st = multi.streams[0]
    window = st.chunk + 2 * st.halo
    audio = _speech(0.4, 0.4, 0.4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [multi.push(i, a[:window]) for i, a in enumerate(audio)]
    # the last push returns its stream's first piece, the others queue
    first = st.chunk + st.halo
    assert [len(o) for o in outs] == [0, 0, first]
    assert [len(p) for p in multi._pending] == [first, first, 0]
    r = _ranges(prof)
    assert len(r["vc.push"]) == 3 and len(r["vc.tick"]) == 1
    last = max(r["vc.push"])
    assert last[0] <= r["vc.tick"][0][0] and r["vc.tick"][0][1] <= last[1]
    for child in ("vc.tick_rows", "vc.convert_batch", "vc.tick_emit"):
        assert len(r[child]) == 1 and _inside(r, child, "vc.tick"), child
    assert _inside(r, "world.f0", "vc.convert_batch")


def _tiny_gan():
    return port_config.Architecture(
        z_dim=8, y_dim=4, y_emb_dim=8,
        encoder=port_config.NetSpec((7, 7), (3, 3), (8, 16)),
        generator=port_config.NetSpec((7, 7, 7), (3, 3, 3), (16, 8, 1)),
        discriminator=port_config.NetSpec((7, 7), (3, 3), (8, 16)),
        training=port_config.TrainConfig(batch_size=8, n_unroll=3))


def _batches(rng, b=8):
    while True:
        y = rng.integers(0, 4, b)
        x = np.tanh(0.5 * rng.standard_normal((b, 513))).astype(np.float32)
        yield x, y.astype(np.int32)


def test_a_vawgan_step_leaves_n_unroll_critic_updates_and_one_generator():
    from tpuvc_torch.train import steps
    arch = _tiny_gan()
    state = steps.init_vawgan_state(arch, 0, "cpu")
    rng = np.random.default_rng(0)
    gen = _batches(rng)
    xs, ys = zip(*(next(gen) for _ in range(4)))
    t = torch.as_tensor
    noise = steps.vawgan_noise(torch.Generator().manual_seed(1), 8, arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps.vawgan_step(state, t(np.stack(xs[:3])),
                          t(np.stack(ys[:3])).long(), t(xs[3]),
                          t(ys[3]).long(), noise)
    r = _ranges(prof)
    assert len(r["train.critic"]) == 3 and len(r["train.generator"]) == 1
    assert max(e for _, e in r["train.critic"]) <= r["train.generator"][0][0]


def test_the_trainers_stages_are_spans(tmp_path):
    """One VAW-GAN trainer step that logs and saves: one ``train.input``
    before the updates, then ``train.log`` and ``train.save``."""
    from tpuvc_torch.train.trainer import VAWGANTrainer
    tr = VAWGANTrainer(_tiny_gan(), str(tmp_path), seed=2,
                       use_tensorboard=False, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train(_batches(np.random.default_rng(3)), total_steps=1,
                 log_every=1, save_every=1)
    tr.close()
    r = _ranges(prof)
    for name, n in (("train.input", 1), ("train.critic", 3),
                    ("train.generator", 1), ("train.log", 1),
                    ("train.save", 1)):
        assert len(r[name]) == n, name
    order = [r[k][0][0] for k in ("train.input", "train.critic",
                                  "train.generator", "train.log",
                                  "train.save")]
    assert order == sorted(order)
