"""The harness finds everything by name and keeps to the contract."""

import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import common, readers

SPEC = common.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files_by_name():
    for w in SPEC["workloads"]:
        wl = common.load_json("workloads", w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert common.load_json("traffic", w["traffic"])["kind"] in (
            "corpus", "live", "train")
        common.load_json("configs", w["config"])
    for c in SPEC["configs"]:
        assert os.path.exists(os.path.join(common.ROOT, c["file"]))
        assert common.load_json("configs", c["name"])["reduced"] == c["reduced"]
    for m in SPEC["per_layer"]:
        assert callable(readers.find(m["name"]))
    for k in common.names("roofline", ".py"):
        mod = common.load_module("roofline", k)
        assert mod.DEVICE_NAMES and mod.REFERENCE and callable(mod.work)


def test_cells_kept_for_later_find_their_files():
    # workload files that BENCHMARK.json does not list yet (PERF.md, open
    # questions) stay whole, so a later change lists them without edits
    for cell in common.names("workloads", ".json"):
        wl = common.load_json("workloads", cell)
        common.load_json("configs", wl["config"])
        assert common.load_json("traffic", wl["traffic"])["kind"] in (
            "corpus", "live", "train")
        assert wl["limits"]


def test_readers_are_found_by_name():
    run = types.SimpleNamespace(
        roofline=None, summary=None, counters={}, spans={},
        config=common.load_json("configs", "vawgan-vcc2016"))
    for name in ("kernels_roofline", "refine_roofline", "events_roofline",
                 "device_idle_pct.corpus", "device_idle_pct.train",
                 "mfu_pct.train", "tick_ms_p50.live"):
        assert readers.find(name)(run) is None     # nothing to read
    with pytest.raises(FileNotFoundError):
        readers.find("fused_roofline")
    with pytest.raises(FileNotFoundError):
        readers.find("no_such_metric.corpus")


def test_the_spec_keeps_to_the_contract():
    assert len(json.dumps(SPEC)) < 64 * 1024
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    cells = {w["name"] for w in SPEC["workloads"]}
    for x in metrics + SPEC["workloads"] + SPEC["configs"]:
        assert NAME.match(x["name"]), x["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get(
            "workloads", cells))
    for c in cells:                     # every cell: setup, one more, a layer
        ends = common.cell_metrics(SPEC, c, "end_to_end")
        assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
        assert common.cell_metrics(SPEC, c, "per_layer")


def test_a_file_added_in_a_copy_is_found(tmp_path, monkeypatch):
    copy = tmp_path / "benchmark"
    shutil.copytree(common.BENCH, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "traffic" / "corpus-burst.json").write_text(json.dumps(
        {**common.load_json("traffic", "corpus"), "utts_per_request": 8}))
    (copy / "workloads" / "vawgan-vcc2016.corpus-burst.json").write_text(
        json.dumps({"config": "vawgan-vcc2016", "traffic": "corpus-burst",
                    "chips": 1}))
    (copy / "metrics" / "answer.corpus.py").write_text(
        "def read(run):\n    return 42.0\n")
    (copy / "roofline" / "fused.py").write_text(
        "DEVICE_NAMES = ('fused_kernel',)\nREFERENCE = ('dio.dio',)\n"
        "def work(*a, out=None, **k):\n    return 4, 0, 0\n")
    monkeypatch.setattr(common, "BENCH", str(copy))
    wl = common.load_json("workloads", "vawgan-vcc2016.corpus-burst")
    assert common.load_json("traffic", wl["traffic"])["utts_per_request"] == 8
    assert common.load_module("metrics", "answer.corpus").read(None) == 42.0
    assert readers.find("answer.corpus")(None) == 42.0
    assert "fused" in common.names("roofline", ".py")
    assert callable(readers.find("fused_roofline"))


def test_the_jax_check_compares_whole_top_level_names():
    mods = {"tpuvc_torch.dsp": types.ModuleType("x"),
            "tpuvc_torch": types.ModuleType("y")}
    assert common.forbidden_loaded(mods) == []
    for bad in ("tpuvc.dsp.dio", "jax", "jaxlib.xla", "flax.linen", "optax"):
        assert common.forbidden_loaded({**mods, bad: None}) == [bad]


def test_the_reference_holds_nothing_of_the_port():
    import benchmark.reference.convert  # noqa: F401
    import benchmark.reference.train  # noqa: F401
    assert common.reference_leaks() == []
    fake = types.ModuleType("benchmark.reference.fake")
    from tpuvc_torch.ops import ulaw
    fake.ulaw_decode = ulaw.ulaw_decode
    fake.dsp = types.ModuleType("tpuvc.dsp")
    assert common.reference_leaks({"benchmark.reference.fake": fake}) == [
        "benchmark.reference.fake.dsp", "benchmark.reference.fake.ulaw_decode"]


def _python(code: str, cwd: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_the_reference_loads_nothing_of_the_port():
    r = _python(
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.reference.convert, benchmark.reference.train\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('tpuvc', 'tpuvc_torch', 'jax', 'jaxlib', 'flax', 'optax')]\n"
        "print(bad)", common.ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_no_card_no_result(tmp_path):
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "vawgan-vcc2016.corpus", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=common.ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""
    # a directory holding only the benchmark: no program, no result
    shutil.copytree(common.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "vawgan-vcc2016.corpus", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.gpu
def test_a_run_on_the_card_prints_its_metrics():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "vawgan-vcc2016.corpus", "--seed", "3", "--seconds", "2",
         "--trace", "0"], cwd=common.ROOT, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}
