"""The benchmark's Harvest configuration (``vawgan-vcc2016-harvest``: the
published VAW-GAN over WORLD's Harvest f0 on its full 1/40-octave bank)
on the CPU, where every kernel wrapper takes its plain version: the cell
through the harness against the plain reference, with the control not
correct; the configuration against the default one; the count of
``benchmark/roofline/refine.py`` (K6) against ``chip_smoke.py:bound_of``;
Harvest's ``hv_recur`` spans; and the readers of the cell's two span
metrics."""

import copy
import types

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark import common, control, peaks, readers, run, spans, trace
from benchmark.tests import small
from tests.conftest import make_speech_like
from tpuvc_torch.dsp import harvest

CELL = "vawgan-vcc2016-harvest.corpus"
CONFIG = common.load_json("configs", "vawgan-vcc2016-harvest")
ROOFLINE = common.load_module("roofline", "refine")
READERS = ("hv_merge_idle_ms_per_call.corpus",
           "hv_recur_idle_ms_per_call.corpus")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the machine: one PyTorch thread
    each (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_cell_is_correct_and_its_control_is_not():
    """The harness's corpus driver on the configuration at a small traffic
    size (published widths, Harvest's full bank): the window is correct
    against the plain reference and reports the corpus cells' end-to-end
    metrics; the control (the reference one precision step lower) misses
    a limit on the same sample, where the program keeps both."""
    out = run.execute(CELL, 2**31 + 27, 0.3, False, device="cpu",
                      **small.overrides(CELL))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}
    lim = common.load_json("workloads", CELL)["limits"]
    r = control.readings(CELL, 2**31 + 28, 0.2, "cpu",
                         **small.overrides(CELL))
    assert set(r["program"]) == set(r["control"]) == set(lim)
    assert all(v <= lim[k] for k, v in r["program"].items()), r
    assert any(v > lim[k] for k, v in r["control"].items()), r


def test_the_configuration_differs_from_the_default_in_its_f0_only():
    base = common.load_json("configs", "vawgan-vcc2016")
    hv = copy.deepcopy(CONFIG)
    assert (hv["world"].pop("f0_method"), base["world"].pop("f0_method")) \
        == ("harvest", "dio")
    # Harvest's full bank, as WORLD runs it
    assert hv["world"]["harvest_channel_decim"] == 1
    assert hv["reduced"] == [] and "morise17b" in hv["source"]
    for k in ("name", "source", "description"):
        hv.pop(k), base.pop(k)
    assert hv == base
    spec = {c["name"]: c for c in common.benchmark_spec()["configs"]}
    entry = spec["vawgan-vcc2016-harvest"]
    assert entry["source"] == CONFIG["source"]
    assert entry["reduced"] == CONFIG["reduced"]
    assert entry["file"] == "benchmark/configs/vawgan-vcc2016-harvest.json"


def test_the_cell_reports_the_corpus_metrics_and_its_own():
    spec = common.benchmark_spec()
    names = {m["name"] for m in common.cell_metrics(spec, CELL,
                                                    "per_layer")}
    default = {m["name"] for m in common.cell_metrics(
        spec, "vawgan-vcc2016.corpus", "per_layer")}
    # no StoneMask on this path (K2), and the default model route
    assert names == (default - {"harmonics_roofline"}) | {
        "refine_roofline", *READERS}
    for m in common.cell_metrics(spec, CELL, "per_layer"):
        assert m["moves"] == "audio_s_per_s"
        assert callable(readers.find(m["name"]))
    cell, = (w for w in spec["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "vawgan-vcc2016-harvest", "corpus", 1)


def _speech(n: int, dur_s: float) -> torch.Tensor:
    kinds = ("sweep", "vibrato")
    return torch.from_numpy(np.stack([
        make_speech_like(kinds[i % 2], dur_s=dur_s, seed=i)[0]
        for i in range(n)]).astype(np.float32))


def test_the_refine_count_is_bound_of_at_a_harvest_shape(monkeypatch):
    """K6's count in ``roofline/refine.py`` gives the least time
    ``chip_smoke.py:bound_of`` gives the wrapper's own arguments and
    result in one Harvest call (2 x 0.3 s, 602 frames x 10 slots), with
    the same bytes."""
    calls = []
    real = harvest.refine_score

    def spy(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(harvest, "refine_score", spy)
    harvest.harvest(_speech(2, 0.3))
    (args, out), = calls
    seg, f0 = args[:2]
    assert f0.shape == (2 * 301, 10) and int((f0 > 0).sum()) > 0
    nbytes, ops, tf32 = ROOFLINE.work(*args, out=out)
    want = chip_smoke.bound_of("refine", args, out)
    assert tf32 == 0
    assert 1e3 * peaks.bound_s(nbytes, ops, tf32) == pytest.approx(
        want["bound_ms"], rel=1e-9)
    assert 1e3 * nbytes / peaks.HBM_BYTES_PER_S == pytest.approx(
        want["bytes_ms"], rel=1e-9)


@pytest.fixture(scope="module")
def traced_call():
    """One Harvest analysis of two utterances inside a stand-in
    ``vc.convert_batch``, traced by the harness's own tracer (host ranges
    only on the CPU), and the f0 of the same call unprofiled."""
    x = _speech(2, 0.2)
    plain = harvest.harvest(x)
    tracer = trace.Tracer(True, float("inf"))
    tracer.start()
    with torch.profiler.record_function("vc.convert_batch"):
        f0 = harvest.harvest(x)
    tracer.stop(types.SimpleNamespace(counters={}, spans={}))
    tracer.finish()
    return plain, f0, tracer.summary


def _ranges(summary, name) -> list[tuple[int, int]]:
    return sorted(zip(*(v.tolist() for v in spans.intervals(summary,
                                                             name))))


def test_hv_recur_opens_six_ranges_inside_hv_contour(traced_call):
    """A profiled Harvest call leaves six ``hv_recur`` ranges (two jump
    removals, two fills, two biquads), one after another inside its one
    ``hv_contour``; the f0 is the unprofiled call's, bit for bit."""
    plain, f0, s = traced_call
    assert torch.equal(plain, f0)
    (cs, ce), = _ranges(s, "hv_contour")
    recur = _ranges(s, "hv_recur")
    assert len(recur) == 6
    assert all(cs <= a < b <= ce for a, b in recur)
    assert all(b <= a2 for (_, b), (a2, _) in zip(recur, recur[1:]))


def _with_device(summary, device) -> trace.Summary:
    """The summary's host ranges with the device events ``device(lo,
    hi)`` (name, start ns, duration ns) of the stand-in call [lo, hi)."""
    host = list(zip(summary.host_names, summary.host_start.tolist(),
                    (summary.host_end - summary.host_start).tolist()))
    (lo, hi), = _ranges(summary, "vc.convert_batch")
    return trace.Summary(device(lo, hi), host, (summary.lo, summary.hi))


def _read(name, summary):
    return readers.find(name)(types.SimpleNamespace(
        summary=summary, counters={}, spans={}))


def test_the_span_readers_read_the_cards_idle_time_inside_the_spans(
        traced_call):
    """With the card busy only after the call, every nanosecond inside
    the spans is idle: ``hv_merge`` reads its range, ``hv_recur`` its six
    ranges summed, per call; with the card busy all through the call,
    nothing."""
    s = _with_device(traced_call[2], lambda lo, hi: [("k", hi, 1)])
    for name, span in zip(READERS, ("hv_merge", "hv_recur")):
        want = sum(b - a for a, b in _ranges(s, span)) / 1e6
        assert want > 0 and _read(name, s) == want
    s = _with_device(traced_call[2], lambda lo, hi: [("k", lo, hi - lo)])
    assert [_read(n, s) for n in READERS] == [0.0, 0.0]


@pytest.mark.parametrize("name", READERS)
def test_the_span_readers_read_none_without_device_events_or_spans(
        name, traced_call):
    assert _read(name, None) is None
    assert _read(name, traced_call[2]) is None       # the CPU: no card
    # a DIO call, or a program without the span: nothing to read
    dio = trace.Summary([("k", 0, 10)], [("vc.convert_batch", 0, 100),
                                          ("world.f0", 10, 50)], (0, 100))
    assert _read(name, dio) is None
