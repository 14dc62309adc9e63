"""PyTorch port: pipeline parallelism (``--n_pipe``, ``--pipe-micro``) on
``torch.distributed`` (``parallel/{mesh,pipeline,sharding}.py``,
``training/{optim,train_step,trainer}.py``, ``apps/train.py``), in gloo
processes on the CPU (``tests/torch_port_dist_worker.py``), held against
the JAX package's ``encode_pipelined`` on ``pipe_mesh(n)`` and its pp train
step (``TrainStepConfig(n_pipe=2, pipe_micro=...)`` on ``make_mesh(n_data,
n_pipe=2)``) over the conftest's CPU devices, on the same weights
(``from_jax_params``) and inputs (numpy, from a seed), and against the
port's single-process run; mirrors ``tests/test_pipeline.py`` and the pp
tests of ``tests/test_parallel_training.py``.

One 4-rank run (the encoder cases, the dp2 x pp2 grid) and one 2-rank run
(the CLI, then pp2 steps in the group it made) start together, and the
JAX and single-process references run here while they do.  The encoder
within JAX's rtol 1e-5 and atol 1e-5; its gradients against autograd
through one process at rtol 2e-4, atol 2e-5; losses within rtol 2e-4 of
JAX's pp mesh, parameters as JAX's ``_assert_trees_close`` (rtol 2e-4,
atol 1e-6); ZeRO-1 on the (data, pipe) grid against the same grid without
it to the bit.
"""

import copy
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_helpers import make_tone_corpus, tiny_train_config
from test_torch_port_parallel import (
    LOSS_TOL, SGD, TREE_TOL, V, _batch, _espnet_batch, join_ranks, start_ranks)
from torch_port_helpers import (
    jax_espnet_model, jax_model, port_model, tiny_espnet_cfg, tiny_model_cfg)
from transformer_transducer_tpu.ops.masks import context_mask as jax_context_mask
from transformer_transducer_tpu.parallel import mesh as jax_mesh
from transformer_transducer_tpu.parallel import sharding as jax_sharding
from transformer_transducer_tpu.parallel.pipeline import (
    encode_pipelined as jax_encode_pipelined, pipe_mesh, stack_encoder_layers,
    stack_espnet_encoder_layers, unstack_encoder_layers, unstack_espnet_encoder_layers)
from transformer_transducer_tpu.training import optim as jax_optim
from transformer_transducer_tpu.training.train_step import (
    TrainStepConfig as JaxStepConfig, compile_train_step)
from transformer_transducer_tpu.utils.config import Config as JaxConfig
from transformer_transducer_tpu_torch.apps import train as train_app
from transformer_transducer_tpu_torch.models.transducer import build_transducer
from transformer_transducer_tpu_torch.ops.masks import context_mask
from transformer_transducer_tpu_torch.parallel.mesh import Mesh, default_n_data, make_mesh
from transformer_transducer_tpu_torch.parallel.pipeline import Pipeline
from transformer_transducer_tpu_torch.training.optim import build_optimizer
from transformer_transducer_tpu_torch.training.train_step import (
    TrainStepConfig, batch_to_device, make_train_step)
from transformer_transducer_tpu_torch.training.trainer import Trainer
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.config import Config, dump_config
from transformer_transducer_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

ENC_TOL = dict(rtol=1e-5, atol=1e-5)          # tests/test_pipeline.py
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)         # test_pipeline_backward_is_reverse_pipeline
SPLITS = [(1, 1), (2, 1), (2, 4), (4, 2), (4, 4)]
N_LAYER = 4
MASK = (4, 2)                                  # context_mask(T, 4, 2), as JAX's test
BAND = (10, 2)                                 # the tiny config's streaming band


def _x(b=4, t=24, seed=0):
    return np.random.RandomState(seed).randn(b, t, 64).astype(np.float32)


def _steps_case(cfg, state, batch, n_data, micro, **kw):
    return {"kind": "steps", "model_cfg": cfg, "flash": True, "state": state,
            "batch": batch, "optim": SGD, "zero": False, "n_data": n_data,
            "n_pipe": 2, "pipe_micro": micro, "steps": 3, **kw}


def _jax_pp(model_j, variables, batch, n_data, micro, pruned=None, espnet=False):
    """JAX's (data n_data, pipe 2) mesh: 3 SGD steps of the pp train step
    on the same weights and batch (no SpecAugment, dropout 0); the losses
    and the parameters in the port's names."""
    mesh = jax_mesh.make_mesh(n_data=n_data, n_model=1, n_pipe=2,
                              devices=jax.devices()[:2 * n_data])
    tx = jax_optim.build_optimizer(JaxConfig(dict(SGD)), 200.0)
    params = dict(jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    stack = stack_espnet_encoder_layers if espnet else stack_encoder_layers
    n_blocks = sum(1 for k in params["encoder"] if k.startswith("layer_"))
    params["encoder"] = stack(params["encoder"], n_blocks)
    opt = tx.init(params)
    step = compile_train_step(model_j, tx, mesh, params, opt,
                              JaxStepConfig(specaug=False, n_pipe=2, pipe_micro=micro,
                                            loss_pruned_range=pruned), donate=False)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(3):
        params, opt, m = step(params, opt, jax_mesh.shard_batch(batch, mesh),
                              jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    params = dict(jax.device_get(params))
    unstack = unstack_espnet_encoder_layers if espnet else unstack_encoder_layers
    params["encoder"] = unstack(params["encoder"])
    return losses, from_jax_params(params)


def _jax_moment_elements(variables):
    """Each port parameter's moment slice shape on JAX's dp2 x pp2 mesh
    with ZeRO-1 (``zero_param_shardings`` of the pipe-stacked tree: the
    layer dimension on ``pipe``, the data axis on a later one), in the
    port's layout; and the elements of a device's share."""
    params = dict(variables["params"])
    params["encoder"] = stack_encoder_layers(params["encoder"], N_LAYER)
    mesh = jax_mesh.make_mesh(n_data=2, n_model=1, n_pipe=2, devices=jax.devices()[:4])
    zshard = jax_sharding.zero_param_shardings(
        params, mesh, jax_sharding.param_shardings(params, mesh))
    shard = jax.tree_util.tree_map(lambda leaf, sh: sh.shard_shape(leaf.shape), params, zshard)
    per_device = sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
        shard, is_leaf=lambda x: isinstance(x, tuple)))
    # one layer's slice: the stacked shard without its layer dimension
    layer = jax.tree_util.tree_map(lambda s: np.zeros((N_LAYER, *s[1:]), np.float32),
                                   shard["encoder"], is_leaf=lambda x: isinstance(x, tuple))
    zeros = {k: jax.tree_util.tree_map(lambda s: np.zeros(s, np.float32), v,
                                       is_leaf=lambda x: isinstance(x, tuple))
             for k, v in shard.items() if k != "encoder"}
    zeros["encoder"] = unstack_encoder_layers(layer)
    return {k: tuple(v.shape) for k, v in from_jax_params(zeros).items()}, per_device


def _one_process(model, batch, pruned=None):
    model.train()
    opt = build_optimizer(Config(dict(SGD)), list(model.parameters()), max_grad_norm=200.0)
    step = make_train_step(model, opt, TrainStepConfig(specaug=False, loss_pruned_range=pruned))
    losses = [float(step(batch_to_device(batch, "cpu"), None)["loss"]) for _ in range(3)]
    return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}


def _espnet_cfgs():
    return {"espnet": tiny_espnet_cfg(vocab=40, d=32),
            "conv": tiny_espnet_cfg("conv2d", vocab=40, d=32, d_in=16)}


def _conv_inputs(seed=5, b=4, t=27):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, 16).astype(np.float32),
            np.array([t - (i % 3) for i in range(b)]))


def _jax_encodes(model_j, variables, conv):
    """JAX's pipelined encoder for every split and under the mask, its
    plain encoder under none, the mask and the band's mask, and the conv2d
    espnet encoder and its lengths."""
    x = jnp.asarray(_x())
    ref = {"jax_encode": {(n, k): np.asarray(jax_encode_pipelined(
               model_j, variables, x, pipe_mesh(n), n_micro=k)) for n, k in SPLITS},
           "jax_plain": np.asarray(model_j.apply(variables, x, method=model_j.encode))}
    mask_j = jax_context_mask(24, *MASK)
    ref["jax_mask"] = np.asarray(jax_encode_pipelined(
        model_j, variables, x, pipe_mesh(4), n_micro=2, attn_mask=mask_j))
    ref["jax_mask_plain"] = np.asarray(model_j.apply(variables, x, mask_j,
                                                     method=model_j.encode))
    ref["jax_band"] = np.asarray(model_j.apply(variables, x, jax_context_mask(24, *BAND),
                                               method=model_j.encode))
    conv_m, conv_v = conv
    conv_x, conv_len = _conv_inputs()
    ref["jax_conv"] = np.asarray(conv_m.apply(conv_v, jnp.asarray(conv_x),
                                              jnp.asarray(conv_len), method="encode"))
    ref["jax_conv_len"] = np.asarray(conv_m.encoded_lengths(jnp.asarray(conv_len), 27))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank run: every (stages, microbatches) split of the encoder,
    under a mask and under the band, its gradients through 4 stages, the
    espnet encoder with a conv2d input layer, the dp2 x pp2 grid and its
    steps (native full and pruned, espnet, ZeRO-1).  The 2-rank run:
    ``apps/train.py --n_pipe 2`` for one epoch of a tone corpus, ``-mode
    continue`` from a one-process ``step_1`` checkpoint, then pp2 steps
    (native full and pruned, espnet, a NaN under the nan guard).
    Meanwhile, here: JAX's references and the single-process runs; after
    both runs the single process's ``-mode continue`` from the 2-rank
    run's checkpoint.  JAX's references run in threads."""
    root = tmp_path_factory.mktemp("pp")
    cfg = tiny_model_cfg(vocab=V, enc_layers=N_LAYER)
    esp = _espnet_cfgs()
    # JAX's work in threads (its compiles leave the interpreter lock)
    pool = ThreadPoolExecutor(4)
    inits = {"native": pool.submit(jax_model, cfg),
             **{k: pool.submit(jax_espnet_model, c) for k, c in esp.items()}}
    vocab, csvs = make_tone_corpus(str(root / "corpus"), n_train=12, n_dev=6)
    train_cfg = Config(tiny_train_config(str(root / "corpus"), vocab, csvs, n_enc=2).to_dict())
    cfg_path = str(root / "tiny.yaml")
    dump_config(train_cfg, cfg_path)
    pp_dir, one_dir, step_dir = root / "pp_cli", root / "one_cli", root / "step_cli"
    for d in (pp_dir, one_dir, step_dir, root / "w2", root / "w4"):
        d.mkdir()
    cwd = os.getcwd()
    try:
        os.chdir(step_dir)
        start = Trainer(train_cfg, device="cpu")
        start.global_step = 1
        start.save_step(0, 1)
    finally:
        os.chdir(cwd)
    argv = ["-config", cfg_path, "--device", "cpu", "--epochs", "1"]
    model_j, variables = inits["native"].result()
    esp_j = {k: inits[k].result() for k in esp}
    state = from_jax_params(variables["params"])
    esp_state = {k: from_jax_params(v[1]["params"]) for k, v in esp_j.items()}
    conv_x, conv_len = _conv_inputs()

    enc = lambda **kw: {"kind": "encode", "model_cfg": cfg, "state": state, "x": _x(), **kw}
    cases4 = [
        *(enc(n_pipe=n, n_micro=k) for n, k in SPLITS),
        enc(n_pipe=4, n_micro=2, mask=context_mask(24, *MASK)),
        {**enc(n_pipe=2, n_micro=2, band=BAND), "flash": False, "banded": True},
        enc(n_pipe=4, n_micro=2, grad=True, x=_x(t=16)),
        {"kind": "encode", "model_cfg": esp["conv"], "state": esp_state["conv"], "x": conv_x,
         "lengths": conv_len, "n_pipe": 2, "n_micro": 4},
        {"kind": "mesh", "n_pipe": 2},
        {"kind": "mesh", "n_pipe": 4},
        _steps_case(cfg, state, _batch(), 2, 2),
        _steps_case(cfg, state, _batch(), 2, 2, pruned=3),
        _steps_case(esp["espnet"], esp_state["espnet"], _espnet_batch(), 2, 2),
        _steps_case(cfg, state, _batch(), 2, 2, zero=True),
    ]
    cases2 = [
        {"kind": "cli", "cwd": str(pp_dir), "argv": argv + ["--n_pipe", "2"]},
        {"kind": "cli", "cwd": str(step_dir),
         "argv": argv + ["--set", "parallel.n_pipe=2", "--set", "parallel.pipe_micro=2",
                         "-mode", "continue"]},
        _steps_case(cfg, state, _batch(), 1, 4),
        _steps_case(cfg, state, _batch(), 1, 4, pruned=3),
        _steps_case(esp["espnet"], esp_state["espnet"], _espnet_batch(), 1, 4),
        _steps_case(cfg, state, _batch(), 1, 4, nan_guard=True, nan_step=1, nan_row=5),
    ]
    started = [start_ranks(4, cases4, root / "w4"), start_ranks(2, cases2, root / "w2")]
    try:
        jobs = {"encodes": pool.submit(_jax_encodes, model_j, variables, esp_j["conv"]),
                "full": pool.submit(_jax_pp, model_j, variables, _batch(), 2, 2),
                "pruned": pool.submit(_jax_pp, model_j, variables, _batch(), 2, 2, pruned=3),
                "espnet": pool.submit(_jax_pp, *esp_j["espnet"], _espnet_batch(), 2, 2,
                                      espnet=True),
                "moments": pool.submit(_jax_moment_elements, variables)}
        ref = {"one": _one_process(port_model(cfg, variables, flash=True), _batch()),
               "states": {"native": state, **esp_state}}
        try:
            os.chdir(one_dir)
            ref["cli_one"] = train_app.main(argv)
        finally:
            os.chdir(cwd)
        for name, job in jobs.items():
            ref[name] = job.result()
        ref.update(ref.pop("encodes"))
    finally:
        pool.shutdown()
        ranks4 = join_ranks(started[0])
        ranks2 = join_ranks(started[1])
    try:
        os.chdir(pp_dir)
        ref["cli_continue"] = train_app.main(["-config", cfg_path, "--device", "cpu",
                                              "--epochs", "2", "-mode", "continue"])
    finally:
        os.chdir(cwd)
    ref["dirs"] = (str(pp_dir), str(one_dir), str(step_dir))
    ref["cfg"] = cfg
    return ranks4, ranks2, ref


# case indices of the 4-rank run
MASKED, BANDED, GRAD, CONV, MESH2, MESH4, DP_FULL, DP_PRUNED, DP_ESPNET, DP_ZERO = range(5, 15)
# ... and of the 2-rank run
CLI, CLI_CONTINUE, PP_FULL, PP_PRUNED, PP_ESPNET, PP_NAN = range(6)


@pytest.mark.parametrize("index, split", list(enumerate(SPLITS)))
def test_encode_pipelined_matches_jax(index, split, runs):
    """Every (stages, microbatches) split: the output on every stage of the
    pipe group against JAX's ``encode_pipelined`` on ``pipe_mesh(n)`` and
    against ``model.encode``."""
    ranks4, _, ref = runs
    n, _ = split
    outs = [r[index] for r in ranks4[:n]]
    assert all(r[index] is None for r in ranks4[n:])      # past the pipe group
    for got in outs:
        np.testing.assert_allclose(got["out"].numpy(), ref["jax_encode"][split], **ENC_TOL)
        np.testing.assert_allclose(got["out"].numpy(), ref["jax_plain"], **ENC_TOL)
        assert torch.equal(got["out"], outs[-1]["out"])    # the last stage's, broadcast


@pytest.mark.parametrize("which", ["mask", "band"])
def test_encode_pipelined_under_a_mask_and_the_band(which, runs):
    """4 stages under ``context_mask(24, 4, 2)`` against JAX's pipelined
    encoder under it and ``model.encode``; 2 stages through the banded
    path under the streaming band against JAX's encoder under the band's
    mask and the port's one-process banded encoder."""
    ranks4, _, ref = runs
    if which == "mask":
        for r in ranks4:
            got = r[MASKED]["out"].numpy()
            np.testing.assert_allclose(got, ref["jax_mask"], **ENC_TOL)
            np.testing.assert_allclose(got, ref["jax_mask_plain"], **ENC_TOL)
        return
    model = build_transducer(Config(copy.deepcopy(ref["cfg"])), banded=True, device="cpu")
    model.load_state_dict(ref["states"]["native"])
    with torch.no_grad():
        one = model.encode_banded(torch.from_numpy(_x()), *BAND).numpy()
    for r in ranks4[:2]:
        got = r[BANDED]["out"].numpy()
        np.testing.assert_allclose(got, ref["jax_band"], **ENC_TOL)
        np.testing.assert_allclose(got, one, **ENC_TOL)


def test_pipeline_backward_matches_autograd(runs):
    """The encoder's gradients of ``sum(h ** 2)`` through 4 stages and 2
    microbatches (the reverse schedule), each on the stage that holds its
    layer, against autograd through one process."""
    ranks4, _, ref = runs
    model = build_transducer(Config(copy.deepcopy(ref["cfg"])), flash=True, device="cpu")
    model.load_state_dict(ref["states"]["native"])
    (model.encode(torch.from_numpy(_x(t=16))) ** 2).sum().backward()
    want = {n: p.grad for n, p in model.named_parameters() if n.startswith("encoder.")}
    got = {}
    for stage, r in enumerate(ranks4):
        mine = r[GRAD]["grads"]
        assert {n.split(".")[2] for n in mine} == {str(stage)}
        got.update(mine)
    assert set(got) == set(want)
    for n, g in want.items():
        np.testing.assert_allclose(got[n].numpy(), g.numpy(), err_msg=n, **GRAD_TOL)


def test_espnet_conv_input_layer_pipelined(runs):
    """The espnet encoder with a conv2d input layer on stage 0 and the
    per-row pad ∧ band mask riding the microbatches: JAX's
    ``model.encode`` within its pipelined test's bars, and the lengths
    mapped alike (``test_espnet_pp_encode_conv_input_layer``)."""
    ranks4, _, ref = runs
    for r in ranks4[:2]:
        got = r[CONV]
        np.testing.assert_allclose(got["out"].numpy(), ref["jax_conv"], rtol=2e-5, atol=1e-5)
        np.testing.assert_array_equal(got["lengths"].numpy(), ref["jax_conv_len"])


@pytest.mark.parametrize("name", ["full", "pruned", "espnet"])
def test_pp_steps_match_the_jax_pp_mesh(name, runs):
    """pp2 (4 microbatches) and dp2 x pp2 (2 microbatches) steps against
    JAX's dp2 x pp2 train step, 3 SGD steps: the losses on every rank and
    the whole model's parameters (gathered over the pipe group)."""
    ranks4, ranks2, ref = runs
    losses_j, params_j = ref[name]
    index4 = {"full": DP_FULL, "pruned": DP_PRUNED, "espnet": DP_ESPNET}[name]
    index2 = {"full": PP_FULL, "pruned": PP_PRUNED, "espnet": PP_ESPNET}[name]
    for r in [r[index4] for r in ranks4] + [r[index2] for r in ranks2]:
        np.testing.assert_allclose(r["loss"], losses_j, **LOSS_TOL)
        assert set(r["params"]) == set(params_j)
        for k, v in params_j.items():
            np.testing.assert_allclose(r["params"][k].numpy(), v.numpy(), err_msg=k,
                                       **TREE_TOL)
    for runs_ in (ranks4, ranks2):
        index = index4 if runs_ is ranks4 else index2
        assert all(r[index]["loss"] == runs_[0][index]["loss"] for r in runs_)


def test_pp_steps_match_one_process(runs):
    """pp2 and dp2 x pp2 against the port's single process on the whole
    batch."""
    ranks4, ranks2, ref = runs
    losses, params = ref["one"]
    for r in [r[DP_FULL] for r in ranks4] + [r[PP_FULL] for r in ranks2]:
        np.testing.assert_allclose(r["loss"], losses, **LOSS_TOL)
        for k, v in params.items():
            np.testing.assert_allclose(r["params"][k].numpy(), v.numpy(), err_msg=k,
                                       **TREE_TOL)


def test_zero_on_the_data_pipe_grid(runs):
    """ZeRO-1 on dp2 x pp2: losses, norms and parameters to the bit of the
    same grid without it; each rank's moment slices have the shapes of
    JAX's ``zero_param_shardings`` share of the pipe-stacked tree, its own
    stage's layers only, and as many elements as a JAX device holds."""
    ranks4, _, ref = runs
    shapes, per_device = ref["moments"]
    for r in ranks4:
        plain, zero = r[DP_FULL], r[DP_ZERO]
        assert plain["loss"] == zero["loss"] and plain["grad_norm"] == zero["grad_norm"]
        for k, v in plain["params"].items():
            assert torch.equal(v, zero["params"][k]), k
        stage = r[MESH2]["pipe_rank"]
        n = 0
        for name, t in zip(zero["names"], zero["moments"]["trace"]):
            layer = name.split(".")[2] if name.startswith("encoder.layers.") else None
            if layer is not None and int(layer) // 2 != stage:
                assert t.numel() == 0, name
                continue
            assert tuple(t.shape) == shapes[name], name
            n += t.numel()
        assert n == per_device
        for key, moments in plain["state_dict"]["state"].items():
            assert all(torch.equal(a, b) for a, b in
                       zip(moments, zero["state_dict"]["state"][key])), key
        assert all(t.shape == p.shape for t, p in
                   zip(zero["state_dict"]["state"]["trace"], plain["params"].values()))


def test_make_mesh_puts_pipe_minor(runs):
    """JAX's ``make_mesh(n_data=2, n_pipe=2)`` layout: rank r at data index
    r // 2 and stage r % 2; the pipe groups hold a data index's stages, the
    data groups a stage's data ranks, adjacent stages share a link; over 4
    stages each link is two ranks."""
    ranks4, _, _ = runs
    grid = jax_mesh.make_mesh(n_data=2, n_model=1, n_pipe=2, devices=jax.devices()[:4])
    ids = [d.id for d in jax.devices()[:4]]
    place = {ids.index(d.id): idx for idx, d in np.ndenumerate(grid.devices)}
    for rank, r in enumerate(ranks4):
        m = r[MESH2]
        d, _, p = place[rank]
        assert (m["data_rank"], m["pipe_rank"]) == (d, p) == (rank // 2, rank % 2)
        assert m["shape"] == {"data": 2, "model": 1, "pipe": 2}
        assert m["pipe_group"] == [2 * d, 2 * d + 1] == list(m["pipe_ranks"])
        assert m["data_group"] == [p, p + 2]
        assert m["is_main"] == (rank == 0)
        m4 = r[MESH4]
        assert m4["pipe_rank"] == rank and m4["data_group"] is None
        assert m4["prev_link"] == (None if rank == 0 else [rank - 1, rank])
        assert m4["next_link"] == (None if rank == 3 else [rank, rank + 1])


@pytest.mark.parametrize("batch, world, n_pipe, micro", [
    (8, 4, 2, 4), (8, 4, 2, 8), (8, 8, 2, 2), (12, 8, 2, 4), (4, 2, 1, 0), (6, 4, 1, 0)])
def test_default_data_axis_uses_the_microbatch(batch, world, n_pipe, micro):
    """JAX's default data axis (``training/trainer.py:146-151``): the
    largest d at most the world over the stages that divides the batch and
    its microbatch (``pipe_micro`` 0: 2 * n_pipe)."""
    avail = world // n_pipe
    per_micro = batch // (micro or 2 * n_pipe) if n_pipe > 1 else batch
    want = max(d for d in range(1, avail + 1) if batch % d == 0 and per_micro % d == 0)
    assert default_n_data(batch, n_pipe=n_pipe, pipe_micro=micro, world=world) == want
    if micro == 8:
        assert want == 1


def test_nonfinite_loss_on_the_last_stage_skips_everywhere(runs):
    """A NaN in row 5 at step 2 under the nan guard: the last stage's loss
    is not finite, and both stages skip that update and keep finite,
    equal parameters."""
    _, ranks2, _ = runs
    a, b = ranks2[0][PP_NAN], ranks2[1][PP_NAN]
    assert a["skipped"] == b["skipped"] == [0, 1, 0]
    assert not np.isfinite(a["loss"][1]) and not np.isfinite(b["loss"][1])
    assert a["state_dict"]["count"] == 2
    for name, t in a["params"].items():
        assert torch.equal(t, b["params"][name]), name
        assert torch.isfinite(t).all(), name


def _validation(log_path):
    lines = [l for l in open(log_path, encoding="utf-8") if "-Validation-" in l]
    loss = float(lines[0].split("AverageLoss: ")[1].split(",")[0])
    cer = float(lines[0].split("CER: ")[1].split()[0])
    return loss, cer


def test_cli_trains_pp2_and_checkpoints_interchange(runs):
    """``apps/train.py --n_pipe 2`` over 2 ranks: default 4 microbatches,
    rank 0 alone writes the log, an ``epoch_0`` checkpoint that holds the
    whole model and moments, and a validation line equal to the single
    process's epoch; a single-process ``-mode continue`` reads it, and
    pp2 (``parallel.n_pipe`` / ``parallel.pipe_micro`` in the config)
    continues a single-process ``step_1`` checkpoint."""
    _, ranks2, ref = runs
    pp_dir, one_dir, step_dir = ref["dirs"]
    one, cont = ref["cli_one"], ref["cli_continue"]
    assert [(r[CLI]["n_pipe"], r[CLI]["pipe_micro"], r[CLI]["n_data"]) for r in ranks2] \
        == [(2, 4, 1)] * 2
    assert ranks2[0][CLI]["global_step"] == one.global_step
    exp = os.path.join(pp_dir, ranks2[0][CLI]["exp_dir"])
    assert [f for f in os.listdir(exp) if f.endswith(".log")] == ["train.log"]
    log = open(os.path.join(exp, "train.log"), encoding="utf-8").read()
    assert "'pipe': 2" in log and "Pipeline: 2 stages of 1 encoder layers" in log
    state = ckpt_lib.load_checkpoint(os.path.join(exp, "epoch_0"), "cpu")
    whole = one.model.state_dict()
    for comp in ckpt_lib.COMPONENTS:
        for k, v in state[comp].items():
            assert v.shape == whole[f"{comp}.{k}"].shape, k
    for t, p in zip(state["optimizer"]["state"]["trace"], one.model.parameters()):
        assert t.shape == p.shape
    loss_pp, cer_pp = _validation(os.path.join(exp, "train.log"))
    loss_one, cer_one = _validation(os.path.join(one_dir, one.exp_dir, "train.log"))
    np.testing.assert_allclose(loss_pp, loss_one, rtol=1e-4)
    assert cer_pp == cer_one
    assert cont.mesh.n_pipe == 1 and cont.start_epoch == 1
    assert cont.global_step == 2 * one.global_step == cont.optimizer.count
    resumed = [r[CLI_CONTINUE] for r in ranks2]
    assert [(r["n_pipe"], r["pipe_micro"]) for r in resumed] == [(2, 2)] * 2
    assert resumed[0]["global_step"] == one.global_step
    exp_step = os.path.join(step_dir, resumed[0]["exp_dir"])
    log = open(os.path.join(exp_step, "train.log"), encoding="utf-8").read()
    assert "Continue mid-epoch" in log and "-Validation-" in log


def _tiny(n_layer=N_LAYER, **kw):
    from transformer_transducer_tpu_torch.models.factory import build_family
    return build_family(Config({"model": tiny_model_cfg(vocab=V, enc_layers=n_layer)}),
                        device="cpu", **kw)


@pytest.mark.parametrize("what", ["layers", "microbatches", "data axis", "model axis",
                                  "seq axis", "int8", "generator", "trainer layers",
                                  "trainer microbatches", "trainer model axis", "cli seq"])
def test_errors_as_jax(what, tmp_path):
    """JAX's checks and messages: layers that do not divide over the
    stages, rows that do not divide into microbatches or microbatches over
    the data axis, ``n_pipe`` with ``n_model`` (composes with the data axis
    only), ``n_pipe`` with ``n_seq`` (JAX's "pick one"), an int8 model, train
    mode without a dropout generator; the trainer's and the CLI's alike.
    Each raises before any hop."""
    x = torch.from_numpy(_x())
    if what in ("layers", "microbatches", "data axis"):
        mesh, micro, rows = {"layers": (Mesh(n_pipe=3, pipe_ranks=(0, 1, 2)), 1, 4),
                             "microbatches": (Mesh(n_pipe=2, pipe_ranks=(0, 1)), 3, 4),
                             "data axis": (Mesh(n_data=2, n_pipe=2, pipe_ranks=(0, 1)), 4, 2)
                             }[what]
        match = {"layers": "n_layer=4 must divide over 3 pipeline stages",
                 "microbatches": "B=4 must divide into 3 microbatches",
                 "data axis": "microbatch size 1 must divide over the 2-way data axis"}[what]
        with pytest.raises(ValueError, match=match):
            Pipeline(_tiny().eval(), mesh, micro).forward(x[:rows], rows, 24)
    elif what == "model axis":
        with pytest.raises(NotImplementedError, match="composes with the data axis only"):
            make_mesh(n_model=2, n_pipe=2)
    elif what == "seq axis":
        with pytest.raises(ValueError, match="pick one"):
            make_mesh(n_pipe=2, n_seq=2)
    elif what == "int8":
        from transformer_transducer_tpu_torch.ops.quant import quantize_modules
        model = quantize_modules(_tiny().eval())
        with pytest.raises(NotImplementedError, match="int8"):
            Pipeline(model, Mesh(n_pipe=2, pipe_ranks=(0, 1)), 2).forward(x, 4, 24)
    elif what == "generator":
        with pytest.raises(ValueError, match="requires a dropout generator"):
            Pipeline(_tiny().train(), Mesh(), 2)
    elif what.startswith("trainer"):
        vocab, csvs = make_tone_corpus(str(tmp_path / "corpus"), n_train=4, n_dev=2)
        cfg = Config(tiny_train_config(str(tmp_path / "corpus"), vocab, csvs,
                                       n_enc=2).to_dict())
        kw, match, err = {
            "trainer layers": ({"n_pipe": 3}, "encoder blocks=2 must divide over 3", ValueError),
            "trainer microbatches": ({"n_pipe": 2, "pipe_micro": 3},
                                     "batch_size=4 must divide into 3 microbatches",
                                     ValueError),
            "trainer model axis": ({"n_pipe": 2, "n_model": 2}, "composes with the data axis",
                                   NotImplementedError)}[what]
        with pytest.raises(err, match=match):
            Trainer(cfg, exp_root=str(tmp_path / "egs"), device="cpu", **kw)
    else:
        with pytest.raises(ValueError, match="pick one"):
            train_app.main(["--device", "cpu", "--n_pipe", "2", "--n_seq", "2"])
