"""The port's data-parallel training over torch.distributed
(tpuvc_torch.parallel.distributed, the process group of train/steps.py,
train/trainer.py and cli/train.py) and its dry run, on the CPU.

Ranks are subprocesses joined by gloo through the JAX side's environment
names (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID) on a free
localhost port (``parallel/dryrun.py:launch_ranks``: one timeout per call,
every rank killed when one fails).  The architectures, batches and seeds
are tests/test_distributed.py's; the parameters come from one Flax init
and the noise from the JAX key chain, so the single-process step is held
against the JAX step too."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from tests.test_distributed import _ARCH_JSON, _GAN_ARCH_JSON
from tests.test_torch_train import _assert_params_close
from tpuvc_torch.parallel import distributed, dryrun
from tpuvc_torch.parallel import mesh as mesh_lib
from tpuvc_torch.train import steps as port_steps
from tpuvc_torch.utils import config as port_config

# subprocess ranks: one thread each, like the test process
RANK_ENV = {"OMP_NUM_THREADS": "1"}
TIMEOUT = 300.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the machine: one PyTorch thread
    each (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_case(model_name):
    """The JAX test's architecture, Flax state, step function, global batch
    and key, with the port's architecture, parameters and the key chain's
    noise for step 0."""
    from tpuvc.models.vae import CVAE, VAWGAN
    from tpuvc.train import steps as jax_steps
    from tpuvc.utils.config import Architecture
    from tpuvc_torch.models import params as port_params
    gan = model_name == "VAWGAN"
    spec = json.loads(_GAN_ARCH_JSON if gan else _ARCH_JSON)
    arch = Architecture.from_json(spec)
    parch = port_config.Architecture.from_json(spec)
    key = jax.random.PRNGKey(1)
    r = jax.random.fold_in(key, 0)
    b = arch.training.batch_size
    if gan:
        model = VAWGAN(arch=arch)
        state = jax_steps.init_vawgan_state(model, arch,
                                            jax.random.PRNGKey(0))
        step = jax_steps.make_vawgan_step(model, arch)
        g = np.random.default_rng(43)
        nu = arch.training.n_unroll
        batch = {"x_crit": g.standard_normal((nu, b, arch.x_dim)).astype(
                     np.float32),
                 "y_crit": np.arange(nu * b).reshape(nu, b) % arch.y_dim,
                 "x_gen": g.standard_normal((b, arch.x_dim)).astype(
                     np.float32),
                 "y_gen": np.arange(b) % arch.y_dim}
        f = lambda i: jax.random.fold_in(r, i)  # noqa: E731
        noise = port_steps.VAWGANNoise(
            _t([jax.random.normal(f(2 * k + 1), (b, arch.z_dim))
                for k in range(nu)]),
            _t([jax.random.uniform(f(2 * k + 2), (b, 1))
                for k in range(nu)]),
            _t(jax.random.normal(f(0), (b, arch.z_dim))))
        tree = jax.device_get(state.params)
        params = {"gen": port_params.from_flax(tree, parch),
                  "critic": port_params.critic_from_flax(tree, parch)}
    else:
        model = CVAE(arch=arch)
        state = jax_steps.init_vae_state(model, arch, jax.random.PRNGKey(0))
        step = jax_steps.make_vae_step(model, arch)
        g = np.random.default_rng(42)
        batch = {"x": g.standard_normal((b, arch.x_dim)).astype(np.float32),
                 "y": np.arange(b) % arch.y_dim}
        noise = _t(jax.random.normal(r, (b, arch.z_dim)))
        params = {"model": port_params.from_flax(
            jax.device_get(state.params), parch)}
    batch = {k: _t(v) for k, v in batch.items()}
    return arch, parch, state, step, batch, key, noise, params


@pytest.mark.parametrize("model_name", ["VAE", "VAWGAN"])
def test_two_process_step_matches_single_process_and_jax(model_name,
                                                          tmp_path):
    """One step of tests/test_distributed.py's VAE (batch 16) and VAW-GAN
    (batch 16, n_unroll 2): two gloo CPU ranks, each on its 8 rows of the
    global batch and noise with gradients averaged by hand, end with
    parameters equal to each other and to the port's single-process step
    on the whole batch (that test's rtol 2e-5, atol 2e-6), and their
    world-mean metrics equal its metrics (rtol 1e-5).  The single-process
    step matches make_vae_step / make_vawgan_step from the same Flax init
    and key chain within PR 8's bound (loss dict rtol 1e-4, parameters
    under tests/test_torch_train.py's parameter rule)."""
    import chip_smoke
    from tpuvc_torch.models import params as port_params
    arch, parch, jstate, jstep, batch, key, noise, params = _jax_case(
        model_name)
    ranks = dryrun.run_dp_step(
        {"arch": parch.to_json(), "params": params, "seed": 0,
         "batch": batch, "noise": noise, "device": "cpu",
         "backend": "gloo"}, 2, str(tmp_path), RANK_ENV, TIMEOUT)
    assert [r["rank"] for r in ranks] == [0, 1]
    assert [r["world"] for r in ranks] == [2, 2]

    state = dryrun.make_state(parch, params, 0, "cpu")
    opts = ((state.opt,) if model_name == "VAE"
            else (state.opt_g, state.opt_d))
    seen = [chip_smoke.record_grads(o) for o in opts]
    m = {k: float(v) for k, v in dryrun.take_step(state, batch,
                                                  noise).items()}
    want = dryrun.step_params(state)
    for r in ranks:
        assert set(r["metrics"]) == set(m)
        for k in m:
            np.testing.assert_allclose(r["metrics"][k], m[k], rtol=1e-5,
                                       err_msg=k)
        for mod, ps in r["params"].items():
            for n, p in ps.items():
                assert torch.equal(p, ranks[0]["params"][mod][n]), (mod, n)
                np.testing.assert_allclose(p.numpy(), want[mod][n].numpy(),
                                           rtol=2e-5, atol=2e-6,
                                           err_msg=f"{mod}.{n}")

    if model_name == "VAE":
        jstate, jm = jstep(jstate, batch["x"].numpy(),
                           batch["y"].numpy().astype(np.int32), key)
    else:
        jstate, jm = jstep(jstate, batch["x_crit"].numpy(),
                           batch["y_crit"].numpy().astype(np.int32),
                           batch["x_gen"].numpy(),
                           batch["y_gen"].numpy().astype(np.int32), key)
    for k in m:
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-4, err_msg=k)
    tree = jax.device_get(jstate.params)
    lr = parch.training.lr
    if model_name == "VAE":
        _assert_params_close(dict(state.model.named_parameters()),
                             port_params.from_flax(tree, parch), seen[0],
                             state.model, lr)
    else:
        _assert_params_close(dict(state.gen.named_parameters()),
                             port_params.from_flax(tree, parch), seen[0],
                             state.gen, lr)
        _assert_params_close(dict(state.critic.named_parameters()),
                             port_params.critic_from_flax(tree, parch),
                             seen[1], state.critic, lr)


def _corpus(root: str) -> str:
    """A 4-speaker synthetic corpus (2 training utterances of 0.5 s each)
    analysed by the port."""
    from tpuvc_torch.data.analyze_corpus import analyze_corpus
    from tpuvc_torch.data.synthetic import make_corpus
    from tpuvc_torch.dsp.constants import DEFAULT_WORLD
    from tpuvc_torch.io import corpus as corpus_io
    make_corpus(root, n_train=2, n_test=0, dur_s=0.5, seed=0)
    analyze_corpus(root, DEFAULT_WORLD, splits=(corpus_io.TRAIN_SPLIT,),
                   device="cpu")
    return root


def _ckpt(run: str, step: int) -> dict:
    return torch.load(os.path.join(run, "ckpt", f"{step}.pt"),
                      weights_only=True)


def _metrics(run: str) -> list[dict]:
    with open(os.path.join(run, "events", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_process_trainer_matches_single_process(tmp_path):
    """python -m tpuvc_torch.cli.train as two gloo CPU ranks: 3 streaming
    steps of tests/test_distributed.py's VAW-GAN (batch 16), then resumed
    from rank 0's checkpoint to step 5 on the resident path (--resident
    2), against the same two cli.train runs in one process.  Rank 0 alone
    made the run directory and wrote the checkpoints (3 and 5) and the
    metrics, whose values are the world's mean; every parameter of step 5
    agrees with the single process's (rtol 2e-5, atol 2e-6), and the
    logged metrics within rtol 1e-4."""
    from tpuvc_torch.cli import train as cli_train
    corpus = _corpus(str(tmp_path / "corpus"))
    arch = str(tmp_path / "arch.json")
    with open(arch, "w") as f:
        f.write(_GAN_ARCH_JSON)
    common = ["--architecture", arch, "--corpus", corpus, "--seed", "2",
              "--no-tensorboard", "--device", "cpu"]

    def run_cli(logdir, launch):
        first = common + ["--logdir", logdir, "--steps", "3"]
        if launch:
            dryrun.launch_ranks(["-m", "tpuvc_torch.cli.train", *first], 2,
                                RANK_ENV, TIMEOUT)
            (stamp,) = os.listdir(os.path.join(logdir, "train"))
            run = os.path.join(logdir, "train", stamp)
        else:
            run = cli_train.main(first)
        again = common + ["--logdir", logdir, "--restore_from", run,
                          "--steps", "5", "--resident", "2"]
        if launch:
            dryrun.launch_ranks(["-m", "tpuvc_torch.cli.train", *again], 2,
                                RANK_ENV, TIMEOUT)
        else:
            cli_train.main(again)
        return run

    dp = run_cli(str(tmp_path / "dp"), True)
    one = run_cli(str(tmp_path / "one"), False)
    assert sorted(os.listdir(os.path.join(dp, "ckpt"))) == ["3.pt", "5.pt"]
    assert os.path.exists(os.path.join(dp, "architecture.json"))
    got, want = _ckpt(dp, 5), _ckpt(one, 5)
    assert got["step"] == want["step"] == 5
    for mod in ("gen", "critic"):
        for n, p in want[mod].items():
            np.testing.assert_allclose(got[mod][n].numpy(), p.numpy(),
                                       rtol=2e-5, atol=2e-6,
                                       err_msg=f"{mod}.{n}")
    m_dp, m_one = _metrics(dp), _metrics(one)
    assert [r["step"] for r in m_dp] == [r["step"] for r in m_one] == [3, 5]
    for a, b in zip(m_dp, m_one):
        for k in b:
            if k not in ("step", "time"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)


def test_trainers_refuse_a_local_multi_device_mesh(tmp_path):
    """Training takes one process per card: a local mesh of several
    devices is refused, naming torchrun; a local mesh of one device trains
    on one device."""
    from tpuvc_torch.train.trainer import make_trainer
    arch = port_config.Architecture.from_json(json.loads(_ARCH_JSON))
    with pytest.raises(ValueError, match="one process per card"):
        make_trainer(arch, str(tmp_path / "a"), device="cpu",
                     use_tensorboard=False,
                     mesh=mesh_lib.make_mesh(devices=["cpu"] * 2))
    t = make_trainer(arch, str(tmp_path / "b"), device="cpu",
                     use_tensorboard=False,
                     mesh=mesh_lib.make_mesh(devices=["cpu"]))
    assert t.mesh is None and t.lead
    t.close()


def test_ensure_initialized_reads_the_environment(monkeypatch):
    """No cluster in the environment: nothing happens (False), and
    global_mesh is this process's one device.  COORDINATOR_ADDRESS without
    NUM_PROCESSES and PROCESS_ID raises."""
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                 "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
        monkeypatch.delenv("JAX_" + name, raising=False)
    assert not torch.distributed.is_initialized()
    assert distributed.ensure_initialized() is False
    mesh = distributed.global_mesh("cpu")
    assert mesh.devices == (torch.device("cpu"),)
    assert not mesh.is_process_group
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        distributed.ensure_initialized()
    assert not torch.distributed.is_initialized()


def test_dryrun_multichip_on_the_cpu(capsys):
    """dryrun_multichip(2, device="cpu"): a 2-rank VAW-GAN step, a sharded
    convert_batch and a frame-sharded analysis, each checked inside."""
    dryrun.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "ok on 2 ranks" in out
    assert "sharded convert ok: 2 utterances over 2 devices" in out
    assert "frame-sharded analysis ok: 201 frames over 2 devices" in out


def test_vawgan_noise_rows_are_the_global_draws():
    """A rank keeps its rows of the global noise: the generator's and each
    critic update's, on the batch axis."""
    arch = port_config.Architecture.from_json(json.loads(_GAN_ARCH_JSON))
    n = port_steps.vawgan_noise(port_steps.step_generator(0, 3, "cpu"), 16,
                                arch)
    half = n.rows(slice(8, 16))
    assert torch.equal(half.z_crit, n.z_crit[:, 8:])
    assert torch.equal(half.gp, n.gp[:, 8:])
    assert torch.equal(half.z_gen, n.z_gen[8:])
