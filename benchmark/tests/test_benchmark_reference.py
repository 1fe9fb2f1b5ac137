"""The plain reference against the port on the CPU at small sizes; the
control and planted faults must come out as not correct."""

import numpy as np
import pytest
import torch

from benchmark import common, control, run
from benchmark.tests import small

# every cell with a workload file: BENCHMARK.json's, and those kept for a
# later change to list (PERF.md, open questions)
CELLS = common.names("workloads", ".json")


def _execute(cell, seed=2**31 + 9, seconds=0.5):
    return run.execute(cell, seed, seconds, False, device="cpu",
                       **small.overrides(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference(cell):
    out = _execute(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_every_seed(cell):
    for seed in (1, 2, 3):
        r = control.readings(cell, seed, 0.3, "cpu", **small.overrides(cell))
        lim = common.load_json("workloads", cell)["limits"]
        assert all(v <= lim[k] for k, v in r["program"].items()), r
        assert any(v > lim[k] for k, v in r["control"].items()), r


def _break_answers(monkeypatch):
    """An answer altered where it is produced: every converted row keeps
    its source speaker's pitch (the f0 transform skipped)."""
    from tpuvc_torch.convert import pipeline
    monkeypatch.setattr(pipeline, "convert_f0", lambda f0, *a: f0)


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    from tpuvc_torch.train import steps
    monkeypatch.setattr(steps, "_update", lambda *a, **k: None)


def _half_batch(monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from tpuvc_torch.train import steps
    real = steps.vawgan_step

    def half(state, x_crit, y_crit, x_gen, y_gen, noise, group=None):
        h = x_gen.shape[0] // 2
        return real(state, x_crit[:, :h], y_crit[:, :h], x_gen[:h],
                    y_gen[:h], noise.rows(slice(0, h)), group)
    monkeypatch.setattr(steps, "vawgan_step", half)


FAULTS = {"corpus": [_break_answers], "live": [_break_answers],
          "train": [_state_unchanged, _half_batch]}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in FAULTS[common.load_json(
        "traffic", common.load_json("workloads", c)["traffic"])["kind"]]])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _execute(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lim = common.load_json("workloads", cell)["limits"]
    for seed in (11, 12, 13):
        r = control.readings(cell, seed, 2.0)
        assert all(v <= lim[k] for k, v in r["program"].items()), r
        assert any(v > lim[k] for k, v in r["control"].items()), r
    assert np.isfinite(list(r["control"].values())).all()
