"""PyTorch port: tensor parallelism (``--n_model``) on ``torch.distributed``
(``parallel/{mesh,sharding,tensor}.py``, the sharded modules and losses,
``training/{optim,train_step,trainer}.py``, ``apps/train.py --n_model``),
in gloo processes on the CPU (``tests/torch_port_dist_worker.py``), held
against the JAX package's ``param_specs`` and its tp mesh
(``make_mesh(n_model=2)`` over the conftest's CPU devices) on the same
weights and batch, and against the port's single-process run; mirrors
``tests/test_sharding.py``, the tp steps of ``tests/test_training.py`` and
``tests/test_rnnt_pruned.py``, and ``tests/test_parallel_training.py``'s
``test_zero_composes_with_tp``.

One 2-rank and one 4-rank run start together, and the JAX and
single-process references run in this process while they do.  Losses
within rtol 2e-4 of JAX's tp mesh and of one process (2e-5 for the pruned
loss and the espnet family, JAX's bar), parameters as JAX's
``_assert_trees_close`` (rtol 2e-4, atol 1e-6); ZeRO-1 on the tp grid
against the same grid without it to the bit.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_helpers import make_tone_corpus, tiny_train_config
from test_torch_port_parallel import (
    ADAM, LOSS_TOL, SGD, TREE_TOL, V, _assert_trees_close, _batch, _espnet_batch,
    _jax_layout, join_ranks, start_ranks)
from torch_port_helpers import (
    jax_espnet_model, jax_model, port_espnet_model, port_model, tiny_espnet_cfg,
    tiny_model_cfg)
from transformer_transducer_tpu.parallel import mesh as jax_mesh
from transformer_transducer_tpu.parallel import sharding as jax_sharding
from transformer_transducer_tpu.training import optim as jax_optim
from transformer_transducer_tpu.training.train_step import (
    TrainStepConfig as JaxStepConfig, compile_train_step)
from transformer_transducer_tpu.utils.config import Config as JaxConfig
from transformer_transducer_tpu_torch.apps import train as train_app
from transformer_transducer_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, make_mesh
from transformer_transducer_tpu_torch.parallel.sharding import (
    param_specs, shard_model, tp_slices)
from transformer_transducer_tpu_torch.training.optim import build_optimizer
from transformer_transducer_tpu_torch.training.train_step import (
    TrainStepConfig, batch_to_device, make_train_step)
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.config import Config, dump_config
from transformer_transducer_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

JAX_TOL = dict(rtol=2e-5)     # tests/test_sharding.py, tests/test_rnnt_pruned.py
FAMILIES = ("native", "tied", "espnet")


def _family(name):
    """(port model config, JAX variables) of a family at test size."""
    if name == "espnet":
        cfg = tiny_espnet_cfg(vocab=40, d=32)
        return cfg, jax_espnet_model(cfg)[1]
    cfg = tiny_model_cfg(vocab=V, share_embedding=name == "tied")
    return cfg, jax_model(cfg)[1]


def _port(name, cfg, variables):
    return (port_espnet_model(cfg, variables) if name == "espnet"
            else port_model(cfg, variables, flash=True))


def _steps_case(cfg, state, batch, optim=SGD, n_data=1, n_model=2, zero=False, **kw):
    return {"kind": "steps", "model_cfg": cfg, "flash": True, "state": state,
            "batch": batch, "optim": optim, "zero": zero, "n_data": n_data,
            "n_model": n_model, "steps": 3, **kw}


def _one_process(model, batch, optim=SGD, pruned=None, steps=3):
    """The port's single-process run: (losses, state dict)."""
    model.train()
    opt = build_optimizer(Config(dict(optim)), list(model.parameters()), max_grad_norm=200.0)
    step = make_train_step(model, opt, TrainStepConfig(specaug=False, loss_pruned_range=pruned))
    losses = [float(step(batch_to_device(batch, "cpu"), None)["loss"]) for _ in range(steps)]
    return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}


# the training flags that compose with --n_model, each a 2-rank case
FLAGS = {"banded": {"banded": True}, "remat": {"flash": True, "remat": True},
         "bf16": {"flash": True, "compute_dtype": torch.bfloat16}}


def _with_flags(cfg, state, flags):
    """The port's native model with ``flags`` (``build_family``'s keywords)
    and ``state``."""
    from transformer_transducer_tpu_torch.models.factory import build_family
    model = build_family(Config({"model": copy.deepcopy(cfg)}), device="cpu", **flags)
    model.load_state_dict(state)
    return model


def _jax_tp2(model_j, variables):
    """JAX's (data 1, model 2) mesh: 3 SGD steps on the same weights and
    batch (no SpecAugment, dropout 0)."""
    mesh = jax_mesh.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
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


def _jax_moment_shapes(variables):
    """Each port parameter's moment slice shape on JAX's dp2 x tp2 mesh
    (``zero_param_shardings`` of the tp specs), in the port's layout."""
    params = variables["params"]
    mesh = jax_mesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    zshard = jax_sharding.zero_param_shardings(
        params, mesh, jax_sharding.param_shardings(params, mesh))
    shards = jax.tree_util.tree_map(
        lambda leaf, sh: np.zeros(sh.shard_shape(leaf.shape), np.float32), params, zshard)
    return {k: tuple(v.shape) for k, v in from_jax_params(shards).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank run: ``apps/train.py --n_model 2`` for one epoch of a
    tone corpus (each rank's entry point joining the group), then in the
    same group ``shard_model``/``gather_model`` of each family, the grid of
    ``make_mesh(n_model=2)``, and 3 tp2 steps each of the native family
    (full and pruned loss), the espnet family, the native family with
    dropout and SpecAugment, and a NaN on model rank 1 alone.  The 4-rank
    run: the dp2 x tp2 grid, and 3 Adam steps on it with and without
    ZeRO-1.  Meanwhile, here: JAX's tp2 steps, the single-process runs and
    the CLI's single-process epoch; after both runs the single process's
    ``-mode continue`` from the 2-rank run's checkpoint."""
    root = tmp_path_factory.mktemp("tp")
    cfg = tiny_model_cfg(vocab=V)
    model_j, variables = jax_model(cfg)
    fam = {"native": (cfg, variables), "tied": _family("tied"), "espnet": _family("espnet")}
    states = {name: from_jax_params(v["params"]) for name, (_, v) in fam.items()}
    vocab, csvs = make_tone_corpus(str(root / "corpus"), n_train=12, n_dev=6)
    train_cfg = Config(tiny_train_config(str(root / "corpus"), vocab, csvs).to_dict())
    cfg_path = str(root / "tiny.yaml")
    dump_config(train_cfg, cfg_path)
    tp_dir, one_dir = root / "tp_cli", root / "one_cli"
    tp_dir.mkdir()
    one_dir.mkdir()
    argv = ["-config", cfg_path, "--device", "cpu", "--epochs", "1"]
    dropout_cfg = dict(copy.deepcopy(cfg), dropout=0.1)
    cases2 = [
        {"kind": "cli", "cwd": str(tp_dir), "argv": argv + ["--n_model", "2"]},
        *({"kind": "roundtrip", "model_cfg": fam[n][0], "state": states[n], "n_model": 2}
          for n in FAMILIES),
        {"kind": "mesh", "n_model": 2},
        _steps_case(cfg, states["native"], _batch()),
        _steps_case(cfg, states["native"], _batch(), pruned=3),
        _steps_case(fam["espnet"][0], states["espnet"], _espnet_batch()),
        _steps_case(dropout_cfg, states["native"], _batch(), seed=7),
        _steps_case(cfg, states["native"], _batch(), nan_guard=True, nan_step=1,
                    nan_row=5, nan_model_rank=1),
        *({**_steps_case(cfg, states["native"], _batch()), "flash": False, **FLAGS[f]}
          for f in FLAGS),
    ]
    cases4 = [{"kind": "mesh", "n_model": 2},
              _steps_case(cfg, states["native"], _batch(), ADAM, n_data=2),
              _steps_case(cfg, states["native"], _batch(), ADAM, n_data=2, zero=True)]
    for d in ("w2", "w4"):
        (root / d).mkdir()
    cwd = os.getcwd()
    started = [start_ranks(4, cases4, root / "w4"), start_ranks(2, cases2, root / "w2")]
    try:
        ref = {"jax_tp2": _jax_tp2(model_j, variables),
               "moment_shapes": _jax_moment_shapes(variables),
               "full": _one_process(_port("native", cfg, variables), _batch()),
               "pruned": _one_process(_port("native", cfg, variables), _batch(), pruned=3),
               "espnet": _one_process(_port("espnet", *fam["espnet"]), _espnet_batch()),
               "adam": _one_process(_port("native", cfg, variables), _batch(), ADAM),
               **{f: _one_process(_with_flags(cfg, states["native"], FLAGS[f]), _batch())
                  for f in FLAGS},
               "states": states}
        try:
            os.chdir(one_dir)
            ref["cli_one"] = train_app.main(argv)
        finally:
            os.chdir(cwd)
    finally:
        ranks4 = join_ranks(started[0])
        ranks2 = join_ranks(started[1])
    try:
        os.chdir(tp_dir)
        ref["cli_continue"] = train_app.main(["-config", cfg_path, "--device", "cpu",
                                              "--epochs", "2", "-mode", "continue"])
    finally:
        os.chdir(cwd)
    ref["dirs"] = (str(tp_dir), str(one_dir))
    return ranks2, ranks4, ref


# case indices of the 2-rank run
CLI, ROUNDTRIP, MESH, FULL, PRUNED, ESPNET, DROPOUT, NAN, FLAGGED = 0, 1, 4, 5, 6, 7, 8, 9, 10


def _marker_tree(params, specs):
    """Each JAX leaf as its index along the ``'model'`` dimension of its
    spec (plus one), zeros for a whole leaf."""
    def marker(leaf, spec):
        spec = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        if jax_mesh.MODEL_AXIS not in spec:
            return np.zeros(leaf.shape, np.float32)
        d = spec.index(jax_mesh.MODEL_AXIS)
        shape = [1] * leaf.ndim
        shape[d] = -1
        idx = np.arange(leaf.shape[d], dtype=np.float32).reshape(shape) + 1
        return np.broadcast_to(idx, leaf.shape).copy()
    return jax.tree_util.tree_map(marker, params, specs)


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_dims_are_jax_param_specs(name):
    """Each port leaf's sharded dimension, read in the JAX layout, is the
    ``'model'`` dimension of JAX's ``param_specs``, and every other leaf is
    whole; rank m's slice holds the elements of JAX's shard m, but for the
    fused ``qkv``, whose slice is rank m's heads of q, k and v."""
    cfg, variables = _family(name)
    params = variables["params"]
    marked = from_jax_params(_marker_tree(params, jax_sharding.param_specs(params)))
    model = _port(name, cfg, variables)
    specs = param_specs(model)
    names = [n for n, _ in model.named_parameters()]
    for rank in range(2):
        slices = dict(zip(names, tp_slices(model, Mesh(n_model=2, model_rank=rank))))
        assert {n for n, s in slices.items() if s is not None} == \
            {n for n, t in marked.items() if bool(t.any())}
        for n, piece in slices.items():
            if piece is None:
                assert MODEL_AXIS not in specs[n]
                continue
            t = marked[n]
            varying = [d for d in range(t.dim()) if t.shape[d] > 1
                       and not torch.equal(t.narrow(d, 0, 1).expand_as(t), t)]
            assert varying == [piece.dim], n
            idx = torch.unique(piece.of(t)).long() - 1
            width = t.shape[piece.dim]
            if "qkv" in n:
                h_dh, local = width // 3, width // 6
                want = torch.cat([torch.arange(local) + s * h_dh + rank * local
                                  for s in range(3)])
            else:
                want = torch.arange(width // 2) + rank * (width // 2)
            assert torch.equal(torch.sort(idx).values, torch.sort(want).values), n


@pytest.mark.parametrize("name, override, n_model, what", [
    ("native", {}, 3, "4 heads"),
    ("native", {"enc": {"d_inner": 130}, "dec": {"d_inner": 130}}, 4, "130 features"),
    ("native", {"joint": {"inner_size": 98}}, 4, "98 features"),
    ("espnet", {}, 8, "4 heads")])
def test_indivisible_widths_raise(name, override, n_model, what):
    """Heads, ``d_inner`` and the joint's inner width that do not divide
    over the model ranks raise a ``ValueError`` naming the leaf, before
    anything is narrowed; too few ranks for the model axis raise JAX's."""
    cfg = tiny_espnet_cfg(vocab=40, d=32) if name == "espnet" else tiny_model_cfg(vocab=V)
    for key, sub in override.items():
        cfg[key] = {**cfg[key], **sub}
    from transformer_transducer_tpu_torch.models.factory import build_family
    model = build_family(Config({"model": cfg}), device="cpu")
    before = {k: v.shape for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=f"{what} on its sharded dimension"):
        shard_model(model, Mesh(n_model=n_model))
    assert {k: v.shape for k, v in model.state_dict().items()} == before
    assert model.tp is None
    with pytest.raises(ValueError, match="model x pipe x seq axes need 2 devices, have 1"):
        make_mesh(n_model=2)


@pytest.mark.parametrize("index, name", list(enumerate(FAMILIES)))
def test_shard_then_gather_returns_the_model(index, name, runs):
    """``shard_model`` then ``gather_model`` over 2 ranks returns the state
    dict to the bit, with no collective left in the forward; the local
    shapes are half the whole on the sharded dimension."""
    ranks2, _, ref = runs
    state = ref["states"][name]
    for r in ranks2:
        got = r[ROUNDTRIP + index]
        assert got["tp"] is None and not any(got["modules_tp"])
        assert set(got["whole"]) == set(state)
        for k, v in state.items():
            assert torch.equal(got["whole"][k], v), k
            local, whole = got["local"][k], tuple(v.shape)
            halved = [d for d in range(len(whole)) if local[d] != whole[d]]
            assert all(2 * local[d] == whole[d] for d in halved), k
            assert len(halved) <= 1, k
    assert any(ranks2[0][ROUNDTRIP + index]["local"][k] != tuple(v.shape)
               for k, v in state.items())


def test_grid_puts_model_minor(runs):
    """``make_mesh(n_model=2)``: rank r at data index r // 2 and model index
    r % 2, as JAX's reshape of its devices; a model group a data index, a
    data group a model index."""
    ranks2, ranks4, _ = runs
    for rank, r in enumerate(ranks2):
        m = r[MESH]
        assert m["shape"] == {"data": 1, "model": 2}
        assert (m["data_rank"], m["model_rank"]) == (0, rank)
        assert m["model_group"] == [0, 1] and m["data_group"] is None
        assert m["is_main"] == (rank == 0)
    for rank, r in enumerate(ranks4):
        m = r[0]
        assert m["shape"] == {"data": 2, "model": 2}
        assert (m["data_rank"], m["model_rank"]) == divmod(rank, 2)
        assert m["model_group"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert m["data_group"] == [rank % 2, rank % 2 + 2]


def test_tp2_matches_the_jax_mesh_and_one_process(runs):
    """tp2, the native family and the full loss, 3 SGD steps: the losses
    and the gathered parameters against JAX's (data 1, model 2) mesh and
    against the port's single process."""
    ranks2, _, ref = runs
    losses_j, params_j = ref["jax_tp2"]
    losses_one, state_one = ref["full"]
    for r in ranks2:
        got = r[FULL]
        assert got["loss"] == ranks2[0][FULL]["loss"]
        np.testing.assert_allclose(got["loss"], losses_j, **LOSS_TOL)
        np.testing.assert_allclose(got["loss"], losses_one, **LOSS_TOL)
        _assert_trees_close(_jax_layout(got["params"]), params_j)
        for k, v in state_one.items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), err_msg=k,
                                       **TREE_TOL)


@pytest.mark.parametrize("case, key", [(PRUNED, "pruned"), (ESPNET, "espnet")])
def test_pruned_loss_and_espnet_at_tp2(case, key, runs):
    """The pruned loss (band 3) and the espnet family at tp2 against one
    process: the losses within JAX's 2e-5, the parameters after 3 steps
    as JAX's trees."""
    ranks2, _, ref = runs
    losses_one, state_one = ref[key]
    for r in ranks2:
        got = r[case]
        np.testing.assert_allclose(got["loss"], losses_one, **JAX_TOL)
        for k, v in state_one.items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), err_msg=k,
                                       **TREE_TOL)


@pytest.mark.parametrize("index, flag", list(enumerate(FLAGS)))
def test_flags_compose_at_tp2(index, flag, runs):
    """``--banded``, ``--remat`` and ``--bf16`` at tp2 against one process
    with the same flag: float32 losses and parameters as above; under bf16
    step 1's loss and norm within the training bars (1e-4, 1e-3), as the
    card holds them (the first clipped update turns the roundings of the
    partial sums into bf16-sized steps)."""
    ranks2, _, ref = runs
    losses_one, state_one = ref[flag]
    for r in ranks2:
        got = r[FLAGGED + index]
        if flag == "bf16":
            np.testing.assert_allclose(got["loss"][0], losses_one[0], rtol=1e-4)
            continue
        np.testing.assert_allclose(got["loss"], losses_one, **LOSS_TOL)
        for k, v in state_one.items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), err_msg=k,
                                       **TREE_TOL)


def test_zero_on_the_tp_grid(runs):
    """dp2 x tp2 on 4 ranks with Adam: ZeRO-1 equal to the bit to the same
    grid without it (losses, norms, parameters), each moment slice of
    JAX's ``zero_param_shardings`` shape of the tp spec, the moment bytes a
    rank their sum; and the grid's losses against one process (Adam's
    normalised update turns the summation order of a near-zero gradient
    into a whole step, so its parameters are held to the bit between the
    two grids only)."""
    _, ranks4, ref = runs
    shapes = ref["moment_shapes"]
    losses_one = ref["adam"][0]
    for r in ranks4:
        plain, zero = r[1], r[2]
        assert plain["loss"] == zero["loss"] and plain["grad_norm"] == zero["grad_norm"]
        for k, t in plain["params"].items():
            assert torch.equal(t, zero["params"][k]), k
        np.testing.assert_allclose(plain["loss"], losses_one, **LOSS_TOL)
        n_bytes = 0
        for i, name in enumerate(zero["names"]):
            for key in ("mu", "nu"):
                assert tuple(zero["moments"][key][i].shape) == shapes[name], (key, name)
            n_bytes += 2 * 4 * int(np.prod(shapes[name]))
        assert zero["moment_bytes"] == n_bytes < plain["moment_bytes"]
        for key, moments in zero["state_dict"]["state"].items():
            for t, name in zip(moments, zero["names"]):
                assert t.shape == ref["states"]["native"][name].shape, (key, name)
                assert torch.equal(t, plain["state_dict"]["state"][key][
                    zero["names"].index(name)]), (key, name)


def test_dropout_keeps_a_model_group_in_step(runs):
    """Dropout 0.1 and SpecAugment, seeded by the data index: after 3
    steps the replicated leaves are bit-equal across the model group, the
    sharded ones are each rank's own, and the gathered parameters are
    finite and moved."""
    ranks2, _, ref = runs
    a, b = (r[DROPOUT] for r in ranks2)
    split = {n for n, s in zip(a["names"], a["tp_slices"]) if s is not None}
    assert split and len(split) < len(a["names"])
    for n in a["names"]:
        if n in split:
            assert not torch.equal(a["local"][n], b["local"][n]), n
        else:
            assert torch.equal(a["local"][n], b["local"][n]), n
    for k, t in a["params"].items():
        assert torch.isfinite(t).all() and torch.equal(t, b["params"][k]), k
    assert a["loss"] == b["loss"]
    assert a["loss"] != ranks2[0][FULL]["loss"]        # the masks dropped units


def test_nonfinite_on_one_model_rank_skips_on_all(runs):
    """A NaN in row 5 of model rank 1's batch alone, at step 2: both ranks
    skip that update, and their parameters stay finite and equal."""
    ranks2, _, _ = runs
    a, b = (r[NAN] for r in ranks2)
    assert a["skipped"] == b["skipped"] == [0, 1, 0]
    assert a["state_dict"]["count"] == b["state_dict"]["count"] == 2
    for k, t in a["params"].items():
        assert torch.isfinite(t).all() and torch.equal(t, b["params"][k]), k


def _validation(log_path):
    lines = [l for l in open(log_path, encoding="utf-8") if "-Validation-" in l]
    return (float(lines[0].split("AverageLoss: ")[1].split(",")[0]),
            float(lines[0].split("CER: ")[1].split()[0]))


def test_cli_trains_at_tp2_and_one_process_continues(runs):
    """``apps/train.py --n_model 2`` over 2 ranks: one epoch, rank 0 alone
    writes the log and an ``epoch_0`` checkpoint holding the whole model
    and moments; the dev loss within 1e-4 of the single-process epoch's
    and the same CER; the replicated leaves equal across the ranks; a
    single-process ``-mode continue`` reads the checkpoint and trains
    epoch 1."""
    ranks2, _, ref = runs
    tp_dir, one_dir = ref["dirs"]
    one, cont = ref["cli_one"], ref["cli_continue"]
    cli = [r[CLI] for r in ranks2]
    assert [c["n_model"] for c in cli] == [2, 2] and [c["n_data"] for c in cli] == [1, 1]
    assert [c["backend"] for c in cli] == ["gloo", "gloo"]
    exp = os.path.join(tp_dir, cli[0]["exp_dir"])
    assert [f for f in os.listdir(exp) if f.endswith(".log")] == ["train.log"]
    log = open(os.path.join(exp, "train.log"), encoding="utf-8").read()
    assert "'model': 2" in log and "rank 1" not in log
    state = ckpt_lib.load_checkpoint(os.path.join(exp, "epoch_0"), "cpu")
    whole = one.model.state_dict()
    for comp in ckpt_lib.COMPONENTS:
        for k, v in state[comp].items():
            assert v.shape == whole[f"{comp}.{k}"].shape, k
    for t, p in zip(state["optimizer"]["state"]["trace"], one.model.parameters()):
        assert t.shape == p.shape
    loss_tp, cer_tp = _validation(os.path.join(exp, "train.log"))
    loss_one, cer_one = _validation(os.path.join(one_dir, one.exp_dir, "train.log"))
    np.testing.assert_allclose(loss_tp, loss_one, rtol=1e-4)
    assert cer_tp == cer_one
    local = [c["local"] for c in cli]
    assert any(not torch.equal(local[0][k], local[1][k]) for k in local[0])
    for k, v in local[0].items():
        if v.shape == whole[k].shape:
            assert torch.equal(v, local[1][k]), k
    assert cont.mesh.n_model == 1 and cont.start_epoch == 1
    assert cont.global_step == 2 * cli[0]["global_step"] == 2 * one.global_step
