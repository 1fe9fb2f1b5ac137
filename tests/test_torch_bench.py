"""The port's two microbenchmarks (tpuvc_torch/bench) against the JAX
repo's (scripts/compute_only.py, scripts/bench_stages.py), on the CPU: the
inputs byte for byte against bench.py's, and each entry's JSON keys from
one small CPU run of chip_smoke.py's bench phase.
"""

import ast
import os
import sys

import numpy as np
import pytest
import torch

from tpuvc_torch.bench import common, compute_only, stages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- inputs ------------------------------------------------------------------

@pytest.mark.parametrize("overtone", [True, False])
def test_inputs_are_bench_py_bytes(overtone):
    """make_inputs against bench.py:158-170 (and compute_only.py's signal
    without the octave), restated here, at batch 3 x 0.25 s."""
    batch, dur_s, fs, sp_dim, y_dim = 3, 0.25, 16000, 513, 10
    t_samples = int(dur_s * fs)
    rng = np.random.default_rng(0)
    t = np.arange(t_samples) / fs
    if overtone:
        xs = np.stack([
            (0.3 * np.sin(2 * np.pi * (110 + 15 * i) * t)
             + 0.1 * np.sin(2 * np.pi * 2 * (110 + 15 * i) * t)
             + 0.01 * rng.standard_normal(t_samples)).astype(np.float32)
            for i in range(batch)])
    else:
        xs = np.stack([
            (0.3 * np.sin(2 * np.pi * (110 + 15 * i) * t)
             + 0.01 * rng.standard_normal(t_samples)).astype(np.float32)
            for i in range(batch)])
    y_trgs = (np.arange(batch) % y_dim).astype(np.int32)
    xmin = np.full(sp_dim, -10.0, np.float32)
    xmax = np.full(sp_dim, 1.0, np.float32)
    mu = np.full(batch, 5.0, np.float32)
    sd = np.ones(batch, np.float32)
    seeds = np.arange(batch, dtype=np.int32)
    want = (xs, y_trgs, xmin, xmax, mu, sd, mu + 0.3, sd, seeds)
    got = common.make_inputs(batch, dur_s, y_dim=y_dim, overtone=overtone)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


# --- the entries -------------------------------------------------------------

def _jax_keys(script):
    """The string keys of each dict literal in a JAX script, and those of
    the ``name["key"] = ...`` stores to each name."""
    tree = ast.parse(open(os.path.join(ROOT, script)).read())
    dicts, stores = [], {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            dicts.append({k.value for k in node.keys
                          if isinstance(k, ast.Constant)})
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and isinstance(t.slice, ast.Constant)):
                    stores.setdefault(t.value.id, set()).add(t.slice.value)
    return dicts, stores


def _holding(dicts, key):
    """The one dict literal that has ``key``."""
    (d,) = [d for d in dicts if key in d]
    return d


def _keys_of_the_jax_scripts():
    _, stage = _jax_keys("scripts/bench_stages.py")
    compute, _ = _jax_keys("scripts/compute_only.py")
    return {"compute_only": _holding(compute, "s_per_call"),
            "stages": stage["results"]}


# the JAX entry points' JSON keys, read from their sources
JAX_KEYS = _keys_of_the_jax_scripts()


@pytest.fixture(scope="module")
def bench_phase():
    """chip_smoke.py's bench phase once on the CPU at a small size:
    compute-only and the stages at K 1 on 2 x 0.5 s and 1 x 0.5 s."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke.phase_bench(
        torch.device("cpu"), batch=2, dur_s=0.5, k=2, reps=1, compute_k=1,
        stage_batch=1)


def test_compute_only_and_stage_entry_keys(bench_phase):
    for impl, rec in bench_phase["compute_only"].items():
        assert set(rec) == JAX_KEYS["compute_only"]
        assert rec["d2s_impl"] == impl
        assert rec["s_per_call"] > 0
    rec = bench_phase["stages"]
    assert set(rec["results"]) == JAX_KEYS["stages"]
    r = rec["results"]
    assert rec["sum (gd)"] == pytest.approx(
        sum(r.values()) - r["d4c_nccf"] - r["excitation"])
    assert "syncs" not in bench_phase             # counted on the card only


def test_chip_smoke_lists_the_jax_keys():
    sys.path.insert(0, ROOT)
    import chip_smoke
    assert chip_smoke.BENCH_KEYS == JAX_KEYS
    assert JAX_KEYS["compute_only"] >= {"s_per_call", "d2s_impl"}


def test_entries_refuse_a_machine_without_a_card(monkeypatch):
    """Every entry defaults to the card and raises without one, before
    building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (compute_only.measure, stages.measure):
        with pytest.raises(RuntimeError, match="CUDA card"):
            run()
