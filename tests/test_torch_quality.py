"""The port's quality studies (tpuvc_torch/quality) against the JAX repo's
(scripts/roundtrip_classes.py, scale_validation.py, convergence_ab.py,
critic_conditioning_ab.py), on the CPU: the signal fixtures bit for bit,
the round trip and the retest floor against the JAX script's functions
with JAX's synthesis noise, the A/B arms as architecture records, and each
study's ``main`` once at a tiny size through chip_smoke.py's phase 10 (a
narrow architecture, a 2-speaker corpus, result files under the test's
directory): the JAX scripts' keys, finite numbers, MCD falling over
training, the launch counters.

The module imports no JAX at top level, as tests/test_torch_bench.py.
"""

import ast
import dataclasses
import importlib.util
import os
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from tpuvc_torch.data import synthetic
from tpuvc_torch.ops._build import counters
from tpuvc_torch.quality import (common, convergence_ab,
                                 critic_conditioning_ab, roundtrip_classes,
                                 scale_validation, signals)
from tpuvc_torch.utils import config as port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

KINDS = ("sweep", "vibrato", "transitions", "low_f0", "breathy", "jitter",
         "bursts")
ABS = ("model", "output_activation", "all", "critic", "alpha")
# tests/test_training.py's narrow architecture, 10 speakers
SMALL = port_config.Architecture(
    z_dim=16, y_dim=10, y_emb_dim=8,
    encoder=port_config.NetSpec((7, 7), (3, 3), (8, 16)),
    generator=port_config.NetSpec((7, 7, 7), (3, 3, 3), (16, 8, 1)),
    discriminator=port_config.NetSpec((7, 7), (3, 3), (8, 16)),
    training=port_config.TrainConfig(batch_size=32, lr=1e-3, n_unroll=2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_corpus(root, n_train=50, n_test=5, style="vowel", parallel=False,
                 **kw):
    """make_vcc2016_corpus cut to the headline pair: SF1 and TM3, at most 2
    training and 1 test utterance of 0.5 s each."""
    defs = {k: synthetic.VCC2016_SPEAKER_DEFS[k] for k in ("SF1", "TM3")}
    synthetic.make_corpus(root, n_train=min(n_train, 2), n_test=1,
                          dur_s=0.5, seed=0, speaker_defs=defs, style=style,
                          parallel=parallel)


def _tree(name: str) -> ast.Module:
    with open(os.path.join(SCRIPTS, name)) as f:
        return ast.parse(f.read())


def _dict_keys(node: ast.Dict) -> set:
    return {k.value for k in node.keys}


def jax_keys() -> dict:
    """The JAX quality scripts' result keys, read from their sources."""
    rt = next(n.value for n in ast.walk(_tree("roundtrip_classes.py"))
              if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
              and ast.unparse(n.targets[0]) == "out[kind]")
    scale = {n.slice.value for n in ast.walk(_tree("scale_validation.py"))
             if isinstance(n, ast.Subscript)
             and isinstance(n.ctx, ast.Store)
             and ast.unparse(n.value) == "results"}
    conv = _tree("convergence_ab.py")
    header = next(n.value for n in ast.walk(conv)
                  if isinstance(n, ast.AnnAssign)
                  and ast.unparse(n.target) == "results")
    milestone = next(n.args[0] for n in ast.walk(conv)
                     if isinstance(n, ast.Call)
                     and ast.unparse(n.func) == "traj.append")
    critic = next(n.value for n in ast.walk(
        _tree("critic_conditioning_ab.py"))
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
        and ast.unparse(n.targets[0]) == "results[name]")
    with open(os.path.join(ROOT, "tpuvc", "cli", "evaluate.py")) as f:
        ev = ast.parse(f.read())
    conv_fn = next(n for n in ev.body if isinstance(n, ast.FunctionDef)
                   and n.name == "_conversion_mcd")
    result = next(n.value for n in ast.walk(conv_fn)
                  if isinstance(n, ast.Assign)
                  and ast.unparse(n.targets[0]) == "result")
    return {"roundtrip": _dict_keys(rt), "scale": scale,
            "convergence": _dict_keys(header),
            "milestone": _dict_keys(milestone),
            "critic": _dict_keys(critic), "evaluate": _dict_keys(result)}


# --- the fixtures' copy ------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_make_speech_like_copy_is_bit_equal(kind):
    """signals.make_speech_like is tests/conftest.py's, bit for bit (all
    three outputs, two seeds; tolerance 0)."""
    from tests.conftest import make_speech_like
    for seed in (0, 1):
        for got, ref in zip(signals.make_speech_like(kind, seed=seed),
                            make_speech_like(kind, seed=seed)):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


def test_make_speech_like_refuses_unknown_kinds():
    with pytest.raises(ValueError):
        signals.make_speech_like("whisper")


# --- the round trip against the JAX script -----------------------------------

def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_noise(seeds, n_samples, device):
    """JAX's synthesis noise for ``seeds`` (jax.random.normal under
    PRNGKey(seed)), in the port's ``synthesis_noise`` signature."""
    import jax
    import jax.numpy as jnp
    return torch.stack([torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.PRNGKey(int(s)), (n_samples,), jnp.float32)))
        for s in np.asarray(seeds).reshape(-1)]).to(device)


@pytest.mark.parametrize("kind", ["sweep", "breathy"])
def test_roundtrip_matches_the_jax_script(kind, monkeypatch):
    """roundtrip_mcd (JAX's synthesis noise injected) and retest_floor of
    the port on the CPU against the JAX script's functions on the same
    signal: within 0.05 dB each."""
    from tpuvc_torch.dsp import world
    jax_rt = _jax_script("roundtrip_classes")
    monkeypatch.setattr(world, "synthesis_noise", jax_noise)
    x, _, _ = signals.make_speech_like(kind, seed=0)
    ref = jax_rt.roundtrip_mcd(x, jax_rt.DEFAULT_WORLD)
    got = roundtrip_classes.roundtrip_mcd(x, roundtrip_classes.DEFAULT_WORLD,
                                          device="cpu")
    assert abs(got - ref) <= 0.05, (got, ref)
    ref = jax_rt.retest_floor(kind, jax_rt.DEFAULT_WORLD)
    got = roundtrip_classes.retest_floor(kind,
                                         roundtrip_classes.DEFAULT_WORLD,
                                         device="cpu")
    assert abs(got - ref) <= 0.05, (got, ref)
    assert roundtrip_classes.KINDS == tuple(next(
        ast.literal_eval(n.iter) for n in ast.walk(_tree(
            "roundtrip_classes.py")) if isinstance(n, ast.For)
        and ast.unparse(n.target) == "kind"))


# --- the A/B arms ------------------------------------------------------------

def jax_arms(ab: str, alphas: str = "25,50,100") -> list:
    """The JAX script's arm list for ``ab``, each arm applied to its
    architecture file by the script's own statements (both read from its
    source): [(name, JAX Architecture)]."""
    from tpuvc.utils.config import Architecture
    main = next(n for n in _tree("convergence_ab.py").body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    chain = next(n for n in ast.walk(main) if isinstance(n, ast.If)
                 and ast.unparse(n.test) == "args.ab == 'model'")
    ns = {}
    exec("def arms(args):\n" + textwrap.indent(ast.unparse(chain), "    ")
         + "\n    return arms\n", ns)
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For)
                and ast.unparse(n.iter) == "arms")
    apply = []
    for stmt in loop.body:
        if ast.unparse(stmt).startswith("run_dir"):
            break
        apply.append(ast.unparse(stmt))
    base = Architecture.load(os.path.join(
        ROOT, "configs", "architecture-vawgan-vcc2016.json"))
    out = []
    for name, overrides in ns["arms"](types.SimpleNamespace(
            ab=ab, alphas=alphas)):
        local = {"base": base, "overrides": overrides,
                 "dataclasses": dataclasses}
        exec("\n".join(apply), local)
        out.append((name, local["arch"]))
    return out


@pytest.mark.parametrize("ab", ABS)
def test_arms_match_the_jax_script(ab):
    """convergence_ab.arms / arm_architecture give the JAX script's arms:
    the same names in order, and architecture records equal field by
    field."""
    base = port_config.Architecture.load(common.ARCH_PATH)
    ours = [(name, convergence_ab.arm_architecture(base, over))
            for name, over in convergence_ab.arms(ab)]
    ref = jax_arms(ab)
    assert [n for n, _ in ours] == [n for n, _ in ref]
    for (name, got), (_, want) in zip(ours, ref):
        got, want = got.to_json(), want.to_json()
        assert set(got) == set(want), name
        for field in want:
            assert got[field] == want[field], (name, field)


def test_unknown_ab_is_refused():
    with pytest.raises(ValueError, match="unknown A/B"):
        convergence_ab.arms("dropout")


# --- the studies on the CPU, through chip_smoke.py's phase 10 ----------------

@pytest.fixture(scope="module")
def phase10(tmp_path_factory):
    """chip_smoke.phase_quality on the CPU at its smallest size: every
    study's main with --device cpu, the narrow architecture, the 2-speaker
    corpus; returns (record, directory, scale_validation.json's bytes
    before the run)."""
    tmp = str(tmp_path_factory.mktemp("quality"))
    arch = os.path.join(tmp, "small.json")
    SMALL.save(arch)
    with open(os.path.join(ROOT, "scale_validation.json"), "rb") as f:
        before = f.read()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "ARCH_PATH", arch)
        mp.setattr(common, "RUNS_DIR", os.path.join(tmp, "runs"))
        mp.setattr(synthetic, "make_vcc2016_corpus", small_corpus)
        rec = chip_smoke.phase_quality(
            torch.device("cpu"), tmp, n_train=2, scale_steps=2,
            conv_steps=40, eval_every=20, n_inner=10, critic_ab_steps=40,
            critic_ab_every=20, critic_steps=2,
            log_every=1)
    return rec, tmp, before


def test_chip_smoke_lists_the_jax_quality_keys():
    assert chip_smoke.QUALITY_KEYS == jax_keys()
    assert jax_keys()["scale"] >= {"config2_x_realtime", "quality_sf1_tm3"}


def test_phase10_rehearses_on_cpu(phase10):
    """Phase 10 ran every study; the CPU takes the plain versions, so no
    counter moved; the card-vs-CPU round trip is CPU against CPU; the
    result files landed in the phase's directory and no file of the
    repository changed (scale_validation.json byte for byte)."""
    rec, tmp, before = phase10
    studies = ("roundtrip_classes", "scale_validation", "convergence_ab",
               "convergence_ab_critic", "critic_conditioning_ab")
    assert set(rec["wall_s"]) == set(studies)
    assert all(rec["launches"][s] == dict.fromkeys(counters(), 0)
               for s in studies)
    assert max(rec["roundtrip_card_vs_cpu_db"].values()) < 1e-3
    files = [os.path.join(tmp, f) for f in ("scale_validation_torch.json",
                                            "critic_ab_torch.json")]
    for path in files:
        blob = common.read_record(path)
        assert blob["card"] == {"device": "cpu"}
        assert common.non_finite(blob) == []
    with open(os.path.join(ROOT, "scale_validation.json"), "rb") as f:
        assert f.read() == before
    assert common.RECORD_PATH == os.path.join(ROOT,
                                              "scale_validation_torch.json")


def test_roundtrip_study_keys(phase10):
    rec = phase10[0]["roundtrip_classes"]
    assert tuple(rec) == roundtrip_classes.KINDS
    for r in rec.values():
        assert set(r) == jax_keys()["roundtrip"]
        assert r["measurement_limited"] == (
            r["roundtrip_mcd_db"] < 1.5 * r["retest_floor_db"]) or abs(
            r["roundtrip_mcd_db"] - 1.5 * r["retest_floor_db"]) < 1e-3
    blob = common.read_record(os.path.join(phase10[1],
                                           "scale_validation_torch.json"))
    assert blob["roundtrip_by_class"] == rec


def test_scale_validation_study_keys(phase10):
    rec = phase10[0]["scale_validation"]
    keys = jax_keys()
    assert set(rec) == keys["scale"]
    assert set(rec["quality_sf1_tm3"]) == keys["evaluate"]
    assert rec["config3_steps"] == 2
    assert rec["config3_final_metrics"]["step"] == 2
    assert rec["config4_n_conversions"] == 2          # SF1 <-> TM3, 1 each
    assert rec["config2_audio_s"] == 10 * (2 + 5) * 1.5
    assert rec["quality_sf1_tm3"]["n_utterances"] == 1
    assert common.non_finite(rec) == []


def test_convergence_study_learns(phase10):
    """Both arms of the model A/B at steps 20 and 40: the JAX keys, and the
    MCD lower at the last milestone (phase 10's own check)."""
    rec = phase10[0]["convergence_ab"]
    keys = jax_keys()
    assert set(rec) == keys["convergence"]
    assert rec["ab"] == "model" and rec["style"] == "vowel"
    assert list(rec["models"]) == ["VAWGAN", "VAE"]
    for traj in rec["models"].values():
        assert [m["step"] for m in traj] == [20, 40]
        assert all(set(m) == keys["milestone"] for m in traj)
        assert traj[-1]["mcd_db"] < traj[0]["mcd_db"]
    blob = common.read_record(os.path.join(phase10[1],
                                           "scale_validation_torch.json"))
    assert blob["convergence_ab"] == rec
    partial = common.read_record(os.path.join(phase10[1], "conv_log",
                                              "partial_results.json"))
    assert partial == rec


def test_convergence_critic_study_learns(phase10):
    """Phase 10's critic A/B of convergence_ab: the unconditioned and the
    conditioned critic at steps 20 and 40, the JAX keys, the MCD lower at
    the last milestone in each arm, recorded as critic_conditioning_ab."""
    rec = phase10[0]["convergence_ab_critic"]
    keys = jax_keys()
    assert set(rec) == keys["convergence"]
    assert rec["ab"] == "critic" and list(rec["models"]) == ["uncond",
                                                             "cond"]
    for traj in rec["models"].values():
        assert [m["step"] for m in traj] == [20, 40]
        assert all(set(m) == keys["milestone"] for m in traj)
        assert traj[-1]["mcd_db"] < traj[0]["mcd_db"]
    blob = common.read_record(os.path.join(phase10[1],
                                           "scale_validation_torch.json"))
    assert blob["critic_conditioning_ab"] == rec


def test_critic_study_keys(phase10):
    rec = phase10[0]["critic_conditioning_ab"]
    keys = jax_keys()
    assert list(rec) == ["unconditional", "conditional"]
    for r in rec.values():
        assert set(r) == keys["critic"]
        assert set(r["eval_sf1_tm3"]) == keys["evaluate"]
        assert [m["step"] for m in r["curve"]] == [1, 2]
        assert {"W_dist", "l_G"} <= set(r["curve"][-1])
    blob = common.read_record(os.path.join(phase10[1],
                                           "critic_ab_torch.json"))
    assert set(blob) == {"unconditional", "conditional", "card"}


def test_convergence_all_writes_both_keys(phase10, monkeypatch):
    """--ab all trains three arms once and writes the model A/B (VAWGAN,
    VAE = the tanh arm) and the decoder-head A/B (tanh, linear), as the
    JAX script does."""
    _, tmp, _ = phase10
    monkeypatch.setattr(common, "ARCH_PATH", os.path.join(tmp, "small.json"))
    path = os.path.join(tmp, "all.json")
    monkeypatch.setattr(common, "RECORD_PATH", path)
    rec = convergence_ab.main([
        "--ab", "all", "--root", os.path.join(tmp, "vcc10"), "--logdir",
        os.path.join(tmp, "all_log"), "--steps", "4", "--eval_every", "4",
        "--n_inner", "2", "--device", "cpu"])
    assert list(rec["models"]) == ["VAWGAN", "tanh", "linear"]
    blob = common.read_record(path)
    assert blob["convergence_ab"]["models"] == {
        "VAWGAN": rec["models"]["VAWGAN"], "VAE": rec["models"]["tanh"]}
    assert blob["output_activation_ab"]["ab"] == "output_activation"
    assert list(blob["output_activation_ab"]["models"]) == ["tanh",
                                                            "linear"]
    assert set(blob["convergence_ab"]) == jax_keys()["convergence"]


def test_tf32_script_records_the_gaps(phase10, monkeypatch):
    """scripts/torch_tf32_quality.py trains the model A/B's VAW-GAN arm
    (on the CPU the flag changes nothing) and records on minus off at the
    milestones the record's convergence_ab shares: the same seed, corpus
    and steps give the same trajectory, so every gap is 0."""
    _, tmp, _ = phase10
    monkeypatch.setattr(common, "ARCH_PATH", os.path.join(tmp, "small.json"))
    path = os.path.join(tmp, "tf32.json")
    monkeypatch.setattr(common, "RECORD_PATH", path)
    on = common.read_record(os.path.join(tmp, "scale_validation_torch.json"))
    common.write_record(path, {"convergence_ab": on["convergence_ab"]},
                        "cpu")
    spec = importlib.util.spec_from_file_location(
        "torch_tf32_quality", os.path.join(SCRIPTS, "torch_tf32_quality.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rec = mod.main(["--root", os.path.join(tmp, "vcc10"), "--logdir",
                    os.path.join(tmp, "tf32_log"), "--steps", "20",
                    "--eval_every", "20", "--n_inner", "10",
                    "--device", "cpu"])
    assert rec["cudnn_tf32"] is False and list(rec["models"]) == ["VAWGAN"]
    assert rec["on_minus_off"] == [{"step": 20, **dict.fromkeys(
        mod.METRICS, 0.0)}]
    assert common.read_record(path)[mod.KEY] == rec
    assert torch.backends.cudnn.allow_tf32           # restored


def _record_script():
    spec = importlib.util.spec_from_file_location(
        "torch_quality_record", os.path.join(SCRIPTS,
                                             "torch_quality_record.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def record_parts(tmp_path_factory):
    """scripts/torch_quality_record.py's ``scale_uncond``,
    ``scale_uncond_linear`` and ``critic`` parts on the CPU at phase 10's
    narrow architecture and 2-speaker corpus (2 streaming steps continued
    to 4; the critic A/B to 4 resident steps in 2 milestones); returns
    (the record, the runs directory, the script module, --out)."""
    tmp = str(tmp_path_factory.mktemp("record"))
    arch = os.path.join(tmp, "small.json")
    SMALL.save(arch)
    runs, out = os.path.join(tmp, "runs"), os.path.join(tmp, "out")
    mod = _record_script()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "ARCH_PATH", arch)
        mp.setattr(common, "RUNS_DIR", runs)
        mp.setattr(common, "RECORD_PATH", os.path.join(tmp, "record.json"))
        mp.setattr(synthetic, "make_vcc2016_corpus", small_corpus)
        mp.setattr(mod, "SCALE_STEPS", 2)
        mp.setattr(mod, "EXTENDED_STEPS", 4)
        mp.setattr(mod, "CONVERGENCE_ARGS", ["--steps", "4", "--eval_every",
                                             "2", "--n_inner", "2"])
        mod.main(["critic", "scale_uncond_linear", "scale_uncond",
                  "--device", "cpu", "--out", out])
        assert (common.ARCH_PATH, common.RECORD_PATH) == (
            arch, os.path.join(tmp, "record.json"))    # restored
        rec = common.read_record(common.RECORD_PATH)
    return rec, runs, mod, out


def test_record_parts_write_their_keys(record_parts):
    """The scale variants write the scale validation's keys under new
    names and none of ``scale``'s: config 2-4 under
    ``scale_validation_<suffix>``, the 1500- and 5000-step scores (here 2
    and 4) under ``quality_sf1_tm3_<suffix>`` / ``..._extended_<suffix>``
    with the changed fields beside them; the critic A/B under
    ``critic_conditioning_ab``; --out gets the record and the A/B's
    partial results."""
    rec, _, mod, out = record_parts
    keys = jax_keys()
    assert set(rec) == {"card", "critic_conditioning_ab"} | {
        f"{k}_{sfx}" for sfx in ("uncond", "uncond_linear") for k in (
            "scale_validation", "quality_sf1_tm3",
            "quality_sf1_tm3_extended")}
    for sfx, fields in (("uncond", {"d_conditional": False}),
                        ("uncond_linear", {"d_conditional": False,
                                           "output_activation": "linear"})):
        sv = rec[f"scale_validation_{sfx}"]
        assert set(sv) == keys["scale"] - {"quality_sf1_tm3"} | set(fields)
        assert sv["config3_steps"] == 2
        q = rec[f"quality_sf1_tm3_{sfx}"]
        assert set(q) == keys["evaluate"] | set(fields)
        assert q["step"] == 2 and {k: q[k] for k in fields} == fields
        ext = rec[f"quality_sf1_tm3_extended_{sfx}"]
        assert ext["step"] == 4 and set(ext) >= keys["evaluate"]
    assert common.non_finite(rec) == []
    assert set(os.listdir(out)) == {"record.json", "partial_critic.json"}
    assert mod.PARTS == ("roundtrip", "scale", "scale_uncond",
                         "scale_uncond_linear", "convergence", "critic",
                         "tf32")


@pytest.mark.parametrize("sfx, fields", [
    ("uncond", {"d_conditional": False}),
    ("uncond_linear", {"d_conditional": False,
                       "output_activation": "linear"})])
def test_record_scale_variant_trains_its_architecture(record_parts, sfx,
                                                      fields):
    """The run directory's architecture.json, written by cli.train at the
    start and again at the continuation, holds ``d_conditional`` false
    (and the linear head) and otherwise ``common.ARCH_PATH``'s
    architecture."""
    rec, runs, _, _ = record_parts
    logdir = os.path.join(runs, f"vcc10_logdir_{sfx}", "train")
    (run_dir,) = os.listdir(logdir)
    got = port_config.Architecture.load(os.path.join(logdir, run_dir,
                                                     "architecture.json"))
    assert got.d_conditional is False
    assert got == dataclasses.replace(SMALL, **fields)
    assert SMALL.d_conditional is True and SMALL.output_activation == "tanh"


def test_record_critic_ab_trains_both_critics(record_parts):
    """``critic`` runs convergence_ab --ab critic: the ``uncond`` and
    ``cond`` arms to each milestone under ``critic_conditioning_ab``, each
    arm's run directory holding its critic's ``d_conditional``."""
    rec, runs, _, out = record_parts
    ab = rec["critic_conditioning_ab"]
    assert set(ab) == jax_keys()["convergence"]
    assert ab["ab"] == "critic" and list(ab["models"]) == ["uncond", "cond"]
    for name, want in (("uncond", False), ("cond", True)):
        assert [m["step"] for m in ab["models"][name]] == [2, 4]
        arch = port_config.Architecture.load(os.path.join(
            runs, "vcc10_critic", name, "architecture.json"))
        assert arch.d_conditional is want
    assert common.read_record(os.path.join(out, "partial_critic.json")) == ab


def test_non_finite_finds_every_bad_number():
    rec = {"a": 1.0, "b": [1, float("nan")], "c": {"d": None, "e": True},
           "f": "x", "g": float("inf")}
    assert common.non_finite(rec) == [".b[1]", ".c.d", ".g"]


def test_studies_refuse_a_machine_without_a_card(monkeypatch, tmp_path):
    """Every study defaults to the card and raises without one unless
    --device cpu is given, before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(common, "RUNS_DIR", str(tmp_path))
    monkeypatch.setattr(common, "RECORD_PATH", str(tmp_path / "r.json"))
    for mod in (roundtrip_classes, scale_validation, convergence_ab,
                critic_conditioning_ab):
        with pytest.raises(RuntimeError, match="CUDA card"):
            mod.main([])
    assert os.listdir(tmp_path) == []
