"""PyTorch port: data parallelism and ZeRO-1 on ``torch.distributed``
(``parallel/{mesh,sharding}.py``, ``training/{optim,train_step,trainer}.py``,
``apps/train.py --n_data --zero``), in several gloo processes on the CPU
(``tests/torch_port_dist_worker.py``), held against the JAX package's dp
mesh (``make_mesh(n_data=4)`` over the conftest's CPU devices) and its
``zero_param_shardings`` on the same weights and batch, and against the
port's single-process run; mirrors ``tests/test_sharding.py`` and the dp
parts of ``tests/test_parallel_training.py``.

Each multi-process run joins its ranks with a timeout, so a hang fails
its tests instead of stalling the suite.  Losses within rtol 2e-4,
parameters as JAX's ``_assert_trees_close`` (rtol 2e-4, atol 1e-6);
ZeRO-1 against plain dp to the bit (its gather adds zeros).
"""

import copy
import logging
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_helpers import make_tone_corpus, tiny_train_config
from transformer_transducer_tpu.parallel import mesh as jax_mesh
from transformer_transducer_tpu.parallel import sharding as jax_sharding
from transformer_transducer_tpu.training import optim as jax_optim
from transformer_transducer_tpu.training.train_step import (
    TrainStepConfig as JaxStepConfig, compile_train_step)
from transformer_transducer_tpu.utils.config import Config as JaxConfig
from transformer_transducer_tpu.utils.torch_convert import transducer_params
from transformer_transducer_tpu_torch.apps import train as train_app
from transformer_transducer_tpu_torch.parallel.mesh import backend_for, make_mesh, \
    shard_batch
from transformer_transducer_tpu_torch.training.optim import build_optimizer
from transformer_transducer_tpu_torch.training.train_step import (
    TrainStepConfig, batch_to_device, make_train_step)
from transformer_transducer_tpu_torch.training.trainer import Trainer
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.config import Config, dump_config
from transformer_transducer_tpu_torch.utils.convert import from_jax_params

from torch_port_helpers import (
    jax_espnet_model, jax_model, port_espnet_model, tiny_espnet_cfg, tiny_model_cfg)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_port_dist_worker.py")
JOIN_S = 240                  # a multi-process run's join timeout
V = 50
B = 8
SGD = {"type": "sgd", "lr": 1e-2, "momentum": 0.9}
ADAM = {"type": "adam", "lr": 1e-3}
GATHER_SMALL = 1000           # a ZeRO-1 gather bucket below the largest leaves
LOSS_TOL = dict(rtol=2e-4)
TREE_TOL = dict(rtol=2e-4, atol=1e-6)     # tests/test_parallel_training.py


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(world, cases, tmp_path):
    """Start ``cases`` on ``world`` gloo ranks (one process each); returns
    what :func:`join_ranks` takes."""
    job = str(tmp_path / "job.pt")
    torch.save({"cases": cases, "out": str(tmp_path / "rank")}, job)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen([sys.executable, WORKER, job], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return world, procs, tmp_path


def run_ranks(world, cases, tmp_path):
    """Run ``cases`` on ``world`` gloo ranks (one process each); rank r's
    results, a list with one entry a case."""
    return join_ranks(start_ranks(world, cases, tmp_path))


def join_ranks(started):
    """Rank r's results of a :func:`start_ranks` run, a list with one entry
    a case; a run that does not end within ``JOIN_S`` fails."""
    world, procs, tmp_path = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{world} ranks did not join within {JOIN_S} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    return [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _batch(seed=0, b=B, tlen=24, u=5):
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randn(b, tlen, 64).astype(np.float32),
            "inputs_length": np.array([tlen] + list(rng.randint(8, tlen + 1, b - 1))),
            "targets": rng.randint(1, V, (b, u)),
            "targets_length": np.array([u] + list(rng.randint(1, u + 1, b - 1)))}


@pytest.fixture(scope="module")
def native():
    cfg = tiny_model_cfg(vocab=V)
    model_j, variables = jax_model(cfg)
    return cfg, model_j, variables, from_jax_params(variables["params"])


def _steps_case(native, optim, zero, n_data, steps=3, **kw):
    cfg, _, _, state = native
    return {"kind": "steps", "model_cfg": cfg, "flash": True, "state": state,
            "batch": _batch(), "optim": optim, "zero": zero, "n_data": n_data,
            "steps": steps, **kw}


ESPNET_D = 32


def _espnet_batch(seed=3, b=4, tlen=30, u=5):
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randn(b, tlen, ESPNET_D).astype(np.float32),
            "inputs_length": np.array([tlen] + list(rng.randint(12, tlen + 1, b - 1))),
            "targets": rng.randint(1, 38, (b, u)),
            "targets_length": np.array([u] + list(rng.randint(1, u + 1, b - 1)))}


@pytest.fixture(scope="module")
def espnet():
    cfg = tiny_espnet_cfg(vocab=40, d=ESPNET_D)
    _, variables = jax_espnet_model(cfg)
    return cfg, variables, from_jax_params(variables["params"])


@pytest.fixture(scope="module")
def world2(native, espnet, tmp_path_factory):
    """One 2-rank run: the mesh checks, plain dp and ZeRO-1 with SGD and with
    Adam, ZeRO-1 with 2 accumulated batches an update, a NaN row on rank 1
    under the nan guard, the espnet family under ZeRO-1, and ZeRO-1 with
    Adam gathering in buckets of 1000 elements, and one banded dp step
    that returns its gradients."""
    esp_cfg, _, esp_state = espnet
    cases = [
        {"kind": "mesh"},
        _steps_case(native, SGD, False, 2),
        _steps_case(native, SGD, True, 2),
        _steps_case(native, ADAM, False, 2),
        _steps_case(native, ADAM, True, 2),
        _steps_case(native, SGD, True, 2, steps=4, accum=2),
        _steps_case(native, SGD, True, 2, nan_guard=True, nan_step=1, nan_row=5),
        {"kind": "steps", "model_cfg": esp_cfg, "state": esp_state,
         "batch": _espnet_batch(), "optim": SGD, "zero": True, "n_data": 2, "steps": 3},
        _steps_case(native, ADAM, True, 2, bucket=GATHER_SMALL),
        _steps_case(native, SGD, False, 2, steps=1, grads=True, flash=False, banded=True),
    ]
    return run_ranks(2, cases, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world4(native, tmp_path_factory):
    cases = [_steps_case(native, SGD, False, 4), _steps_case(native, SGD, True, 4)]
    return run_ranks(4, cases, tmp_path_factory.mktemp("world4"))


@pytest.fixture(scope="module")
def jax_dp4(native):
    """JAX's dp mesh of 4 CPU devices: 3 SGD steps on the same weights and
    batch (no SpecAugment, dropout 0)."""
    _, model_j, variables, _ = native
    mesh = jax_mesh.make_mesh(n_data=4, devices=jax.devices()[:4])
    tx = jax_optim.build_optimizer(JaxConfig(dict(SGD)), 200.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt = tx.init(params)
    step = compile_train_step(model_j, tx, mesh, params, opt,
                              JaxStepConfig(specaug=False), donate=False)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    losses = []
    for _ in range(3):
        params, opt, m = step(params, opt, jax_mesh.shard_batch(batch, mesh),
                              jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return losses, jax.device_get(params)


def _jax_layout(state):
    """A port state dict as the JAX parameter tree."""
    sd = lambda prefix: {k[len(prefix):]: v.numpy() for k, v in state.items()
                         if k.startswith(prefix)}
    return transducer_params(sd("encoder."), sd("decoder."), sd("joint."))["params"]


def _assert_trees_close(a, b):
    jax.tree_util.tree_map(
        lambda x, y: np.testing.assert_allclose(np.asarray(x), np.asarray(y), **TREE_TOL),
        a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_matches_the_jax_mesh(world, jax_dp4, request):
    """dp over 2 and 4 ranks, plain and ZeRO-1: the losses (the global
    batch's mean) and the parameters after 3 steps against JAX's dp4."""
    runs = request.getfixturevalue(f"world{world}")
    losses_j, params_j = jax_dp4
    first = 1 if world == 2 else 0          # world2's case 0 is the mesh check
    for case in (first, first + 1):
        ranks = [r[case] for r in runs]
        for r in ranks:
            np.testing.assert_allclose(r["loss"], losses_j, **LOSS_TOL)
            assert r["loss"] == ranks[0]["loss"]       # one global mean
        for r in ranks:
            _assert_trees_close(_jax_layout(r["params"]), params_j)


def _slice_dims_of_jax(native, mesh):
    """For each port parameter name, the port dimension that carries JAX's
    ZeRO-1 data axis (None: the leaf stays whole)."""
    _, _, variables, _ = native
    params = variables["params"]
    pshard = jax_sharding.param_shardings(params, mesh)
    zshard = jax_sharding.zero_param_shardings(params, mesh, pshard)

    def marker(leaf, sh):
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        if jax_mesh.DATA_AXIS not in spec:
            return np.zeros(leaf.shape, np.float32)
        d = spec.index(jax_mesh.DATA_AXIS)
        idx = np.arange(leaf.shape[d], dtype=np.float32) + 1
        shape = [1] * leaf.ndim
        shape[d] = -1
        return np.broadcast_to(idx.reshape(shape), leaf.shape).copy()
    marked = from_jax_params(jax.tree_util.tree_map(marker, params, zshard))
    out = {}
    for name, t in marked.items():
        varying = [d for d in range(t.dim()) if t.shape[d] > 1
                   and not torch.equal(t.narrow(d, 0, 1).expand_as(t), t)]
        out[name] = varying[0] if varying else None
    return out


@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_zero_matches_dp_with_jax_slices(optim, native, world2):
    """ZeRO-1 against plain dp over 2 ranks: losses, gradient norms and
    parameters to the bit; each moment slice on the dimension of JAX's
    ``zero_param_shardings`` spec (2 devices), the ranks' slices tiling the
    plain run's moment, the gathered ``state_dict`` equal to it, and half
    the moment bytes a rank."""
    plain_case, zero_case = (1, 2) if optim == "sgd" else (3, 4)
    plain = [r[plain_case] for r in world2]
    zero = [r[zero_case] for r in world2]
    for p, z in zip(plain, zero):
        assert p["loss"] == z["loss"] and p["grad_norm"] == z["grad_norm"]
        for name, t in p["params"].items():
            assert torch.equal(t, z["params"][name]), name
    mesh2 = jax_mesh.make_mesh(n_data=2, devices=jax.devices()[:2])
    want_dims = _slice_dims_of_jax(native, mesh2)
    names = zero[0]["names"]
    n_split = 0
    for i, name in enumerate(names):
        pieces = [z["slices"][i] for z in zero]
        dim = None if pieces[0] is None else pieces[0].dim
        assert dim == want_dims[name], name
        for key, moments in plain[0]["moments"].items():
            whole = moments[i]
            if dim is None:
                assert all(torch.equal(z["moments"][key][i], whole) for z in zero), name
                continue
            assert [s.start for s in pieces] == [0, whole.shape[dim] // 2]
            tiled = torch.cat([z["moments"][key][i] for z in zero], dim)
            assert torch.equal(tiled, whole), (key, name)
            assert torch.equal(zero[0]["state_dict"]["state"][key][i], whole)
        n_split += dim is not None
    assert n_split == len(names)           # every leaf of the tiny model divides by 2
    assert all(2 * z["moment_bytes"] == plain[0]["moment_bytes"] for z in zero)


def test_zero_gathers_in_buckets(world2):
    """ZeRO-1's gather in buckets of 1000 elements (several leaves a
    bucket, a larger leaf alone): Adam's losses, parameters and gathered
    moments equal to the bit to plain dp's."""
    plain, zero = [r[3] for r in world2], [r[8] for r in world2]
    sizes = [t.numel() for t in plain[0]["params"].values()]
    assert max(sizes) > GATHER_SMALL and min(sizes) < GATHER_SMALL // 2
    for p, z in zip(plain, zero):
        assert p["loss"] == z["loss"] and p["grad_norm"] == z["grad_norm"]
        for name, t in p["params"].items():
            assert torch.equal(t, z["params"][name]), name
        for key, moments in p["moments"].items():
            assert all(torch.equal(a, b) for a, b in
                       zip(moments, z["state_dict"]["state"][key])), key


def test_zero_moments_over_four_ranks(world4):
    """ZeRO-1 over 4 ranks: a quarter of each divisible leaf's moment (the
    odd vocabulary's bias stays whole), parameters equal to plain dp."""
    plain, zero = [r[0] for r in world4], [r[1] for r in world4]
    for p, z in zip(plain, zero):
        assert p["loss"] == z["loss"]
        for name, t in p["params"].items():
            assert torch.equal(t, z["params"][name]), name
    sizes = [t.numel() for t in plain[0]["moments"]["trace"]]
    want = sum(n if s is None else n // 4 for n, s in zip(sizes, zero[0]["slices"]))
    assert zero[0]["moment_bytes"] == 4 * want
    assert 4 * want < 0.26 * sum(sizes) * 4


def test_zero_grad_accumulation_matches_one_process(native, world2):
    """2 batches an update under ZeRO-1 over 2 ranks (each micro-step's
    gradient averaged over the ranks) against the single-process port."""
    cfg, _, _, state = native
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    model = build_transducer(Config(copy.deepcopy(cfg)), flash=True, device="cpu")
    model.load_state_dict(state)
    model.train()
    opt = build_optimizer(Config(dict(SGD)), list(model.parameters()),
                          max_grad_norm=200.0, grad_accum_steps=2)
    step = make_train_step(model, opt, TrainStepConfig(specaug=False))
    losses = [float(step(batch_to_device(_batch(), "cpu"), None)["loss"])
              for _ in range(4)]
    for r in world2:
        got = r[5]
        np.testing.assert_allclose(got["loss"], losses, **LOSS_TOL)
        for name, t in model.state_dict().items():
            np.testing.assert_allclose(got["params"][name].numpy(), t.numpy(),
                                       err_msg=name, **TREE_TOL)
    assert world2[0][5]["state_dict"]["count"] == 2


def test_nonfinite_row_on_one_rank_skips_on_all(world2):
    """A NaN in row 5 (rank 1's) at step 2: both ranks skip that update and
    keep the same parameters as each other."""
    a, b = world2[0][6], world2[1][6]
    assert a["skipped"] == b["skipped"] == [0, 1, 0]
    assert not np.isfinite(a["loss"][1]) and not np.isfinite(b["loss"][1])
    assert a["state_dict"]["count"] == 2
    for name, t in a["params"].items():
        assert torch.equal(t, b["params"][name]), name
        assert torch.isfinite(t).all(), name


def test_espnet_family_at_dp2(espnet, world2):
    """The espnet family under ZeRO-1 over 2 ranks against the
    single-process port on the whole batch."""
    cfg, variables, _ = espnet
    model = port_espnet_model(cfg, variables).train()
    opt = build_optimizer(Config(dict(SGD)), list(model.parameters()), max_grad_norm=200.0)
    step = make_train_step(model, opt, TrainStepConfig(specaug=False))
    losses = [float(step(batch_to_device(_espnet_batch(), "cpu"), None)["loss"])
              for _ in range(3)]
    for r in world2:
        got = r[7]
        np.testing.assert_allclose(got["loss"], losses, **LOSS_TOL)
        for name, t in model.state_dict().items():
            np.testing.assert_allclose(got["params"][name].numpy(), t.numpy(),
                                       err_msg=name, **TREE_TOL)


def test_dp_gradients_equal_the_one_process_split_mean(native, world2):
    """The split yardstick: step 1's gradients of banded dp over 2 ranks
    (after the all-reduce and the division) equal to the bit, leaf by leaf,
    the mean ``(g0 + g1) / 2`` in float32 of one process's gradients on
    each rank's rows; the 8-row step's gradients differ from it only by
    the reassociation of the batch sums."""
    cfg, _, _, state = native
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.training.train_step import make_loss_fn
    model = build_transducer(Config(copy.deepcopy(cfg)), banded=True, device="cpu")
    model.load_state_dict(state)
    model.train()
    loss_fn = make_loss_fn(model, TrainStepConfig(specaug=False))
    batch = batch_to_device(_batch(), "cpu")

    def grads(rows):
        model.zero_grad(set_to_none=True)
        loss_fn({k: v[rows] for k, v in batch.items()}, None).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}
    g0, g1 = grads(slice(0, B // 2)), grads(slice(B // 2, B))
    whole = grads(slice(0, B))
    for r in world2:
        got = r[9]["grads"]
        assert set(got) == set(whole)
        for name, g in got.items():
            assert torch.equal(g, (g0[name] + g1[name]) / 2), name
            np.testing.assert_allclose(g.numpy(), whole[name].numpy(), err_msg=name,
                                       rtol=1e-4, atol=1e-6)


def test_make_mesh_defaults_and_shrinks(world2, caplog):
    """The data axis defaults to the world size; an oversized request
    shrinks to it with JAX's warning (one process here, two in the gloo
    run); a seq or pipe axis wider than the world raises JAX's error
    (tensor, pipeline and sequence parallelism train:
    tests/test_torch_port_tensor_parallel.py, tests/test_torch_port_pipeline.py,
    tests/test_torch_port_sequence.py)."""
    for r in world2:
        assert r[0]["default"] == 2 and r[0]["shrunk"] == 2
        assert any("shrinking the data axis to 2" in w for w in r[0]["warnings"])
    with caplog.at_level(logging.WARNING, logger="transformer_transducer_tpu"):
        assert make_mesh().n_data == 1
        assert make_mesh(n_data=4).n_data == 1
    assert "shrinking the data axis to 1" in caplog.text
    with pytest.raises(ValueError, match="model x pipe x seq axes need 2 devices, have 1"):
        make_mesh(n_seq=2)
    with pytest.raises(ValueError, match="model x pipe x seq axes need 2 devices, have 1"):
        make_mesh(n_pipe=2)


def test_shard_batch_takes_jax_rows():
    """Rank r keeps rows r*B/n .. (r+1)*B/n, the rows ``P('data')`` gives
    JAX device r."""
    from transformer_transducer_tpu_torch.parallel.mesh import Mesh
    batch = {"inputs": np.arange(8 * 3).reshape(8, 3), "targets": torch.arange(8)}
    mesh_j = jax_mesh.make_mesh(n_data=4, devices=jax.devices()[:4])
    placed = jax_mesh.shard_batch({"inputs": jnp.asarray(batch["inputs"])}, mesh_j)
    shards = {s.device: np.asarray(s.data) for s in placed["inputs"].addressable_shards}
    for rank, dev in enumerate(mesh_j.devices.reshape(-1)):
        got = shard_batch(batch, Mesh(n_data=4, data_rank=rank))
        np.testing.assert_array_equal(got["inputs"], shards[dev])
        assert got["targets"].tolist() == list(range(2 * rank, 2 * rank + 2))
    with pytest.raises(ValueError, match="divide"):
        shard_batch({"x": np.zeros(6)}, Mesh(n_data=4, data_rank=0))


@pytest.mark.parametrize("device, local, cards, want", [
    ("cpu", "1", 0, "gloo"), ("cpu", "4", 4, "gloo"), ("cuda", "1", 1, "nccl"),
    ("cuda", "4", 4, "nccl"), ("cuda", "2", 1, "gloo"), ("cuda", None, 1, "gloo")])
def test_backend_follows_the_cards(device, local, cards, want, monkeypatch):
    """NCCL with a card a rank; gloo on the CPU and when more local ranks
    (``LOCAL_WORLD_SIZE``, else ``WORLD_SIZE``) than cards share a card."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert backend_for(torch.device(device)) == want


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``apps/train.py --n_data 2 --set parallel.zero=true`` for one epoch of
    a tone corpus over 2 gloo ranks (in groups of 2 steps,
    ``--steps-per-call 2``), each rank's entry point joining the group from
    the environment; then, in the same ranks, ``-mode continue`` from a
    one-process ``step_1`` checkpoint; the same epoch in one process, and
    the single process's ``-mode continue`` from the 2-rank run's
    checkpoint."""
    root = tmp_path_factory.mktemp("cli")
    vocab, csvs = make_tone_corpus(str(root / "corpus"), n_train=12, n_dev=6)
    cfg = Config(tiny_train_config(str(root / "corpus"), vocab, csvs).to_dict())
    path = str(root / "tiny.yaml")
    dump_config(cfg, path)
    dp_dir, one_dir, step_dir = root / "dp", root / "one", root / "step"
    for d in (dp_dir, one_dir, step_dir):
        d.mkdir()
    cwd = os.getcwd()
    try:
        os.chdir(step_dir)
        start = Trainer(cfg, device="cpu")
        start.global_step = 1
        start.save_step(0, 1)
    finally:
        os.chdir(cwd)
    argv = ["-config", path, "--device", "cpu", "--epochs", "1"]
    ranks = run_ranks(2, [{"kind": "cli", "cwd": str(dp_dir),
                           "argv": argv + ["--n_data", "2", "--set", "parallel.zero=true",
                                           "--steps-per-call", "2"]},
                          {"kind": "cli", "cwd": str(step_dir),
                           "argv": argv + ["--n_data", "2", "-mode", "continue"]}],
                      root)
    try:
        os.chdir(one_dir)
        one = train_app.main(argv)
        os.chdir(dp_dir)
        cont = train_app.main(["-config", path, "--device", "cpu", "--epochs", "2",
                               "-mode", "continue"])
    finally:
        os.chdir(cwd)
    return ranks, one, cont, str(dp_dir), str(one_dir)


def _validation(log_path):
    lines = [l for l in open(log_path, encoding="utf-8") if "-Validation-" in l]
    loss = float(lines[0].split("AverageLoss: ")[1].split(",")[0])
    cer = float(lines[0].split("CER: ")[1].split()[0])
    return loss, cer


def test_cli_trains_zero1_and_one_process_continues(cli_runs):
    """The 2-rank run (``parallel.zero`` through the CLI and the trainer):
    rank 0 alone writes the log and an ``epoch_0`` checkpoint whose moments
    are whole; its dev loss and CER equal the single-process epoch's; a
    single-process ``-mode continue`` reads it and trains epoch 1."""
    ranks, one, cont, dp_dir, one_dir = cli_runs
    assert [r[0]["n_data"] for r in ranks] == [2, 2]
    assert all(r[0]["zero"] for r in ranks)
    assert 2 * ranks[0][0]["moment_bytes"] == one.optimizer.moment_bytes()
    exp = os.path.join(dp_dir, "egs", "synth", one.config.training.save_model or "model")
    logs = [f for f in os.listdir(exp) if f.endswith(".log")]
    assert logs == ["train.log"]
    log = open(os.path.join(exp, "train.log"), encoding="utf-8").read()
    assert "'data': 2" in log and "ZeRO-1 on" in log and "rank 1" not in log
    state = ckpt_lib.load_checkpoint(os.path.join(exp, "epoch_0"), "cpu")
    for t, p in zip(state["optimizer"]["state"]["trace"], one.model.parameters()):
        assert t.shape == p.shape
    loss_dp, cer_dp = _validation(os.path.join(exp, "train.log"))
    loss_one, cer_one = _validation(os.path.join(one_dir, one.exp_dir, "train.log"))
    np.testing.assert_allclose(loss_dp, loss_one, rtol=1e-4)
    assert cer_dp == cer_one
    assert cont.mesh.n_data == 1 and cont.start_epoch == 1
    assert cont.global_step == 2 * ranks[0][0]["global_step"] == 2 * one.global_step
    assert cont.optimizer.count == cont.global_step


def test_cli_joins_the_group_and_resumes_with_dropout_spread(cli_runs):
    """Each rank's entry point joined a gloo group from the environment (on
    the CPU); after a ``-mode continue`` from a ``step_*`` checkpoint, which
    holds rank 0's generator state, the ranks' torch generators differ
    again, so their dropout masks do, as in a fresh run."""
    ranks = cli_runs[0]
    assert [r[0]["backend"] for r in ranks] == ["gloo", "gloo"]
    resumed = [r[1] for r in ranks]
    assert [r["n_data"] for r in resumed] == [2, 2]
    assert resumed[0]["global_step"] == resumed[1]["global_step"] == ranks[0][0]["global_step"]
    assert not torch.equal(resumed[0]["rng"], resumed[1]["rng"])
