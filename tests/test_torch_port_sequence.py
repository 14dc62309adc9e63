"""PyTorch port: sequence parallelism (``--n_seq``) on ``torch.distributed``
(``parallel/{mesh,sequence}.py``, ``training/{train_step,trainer}.py``,
``apps/train.py``), in gloo processes on the CPU
(``tests/torch_port_dist_worker.py``), held against the JAX package's
``encode_banded_sp`` / ``encode_banded_sp_espnet`` on ``seq_mesh(n)``, its
``encode_banded_sp_oracle``, and its sp train step
(``TrainStepConfig(n_seq=2, sp_window=64)`` on ``make_mesh(n_data=2 |
n_model=2, n_seq=2)``) over the conftest's CPU devices, on the same
weights (the port's, seeded, through the JAX package's
``utils/torch_convert.py``: no flax init) and inputs (numpy, from a seed),
and against the port's one-process runs; mirrors
``tests/test_sequence_parallel.py`` and the sp tests of
``tests/test_parallel_training.py``.

One 4-rank run (4-shard encodes, the encoder's gradients, the espnet
encoder with ragged lengths, the meshes, the dp2 x sp2 and tp2 x sp2
grids and their steps) and one 2-rank run (the CLI, then 2-shard encodes
and the espnet conv2d encoder in the group it made) start together, and
the JAX and one-process references run here while they do.  The encoder
within JAX's rtol 1e-5 and atol 1e-5; its gradients against autograd
through the one-process oracle at rtol 2e-4, atol 2e-5; losses within
rtol 2e-4 of JAX's sp mesh, parameters as JAX's ``_assert_trees_close``
(rtol 2e-4, atol 1e-6); ZeRO-1 on the (data, seq) grid against the same
grid without it to the bit.
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
from torch_port_helpers import tiny_espnet_cfg, tiny_model_cfg
from transformer_transducer_tpu.models.espnet_variant import (
    build_espnet_transducer as jax_build_espnet)
from transformer_transducer_tpu.models.transducer import build_transducer as jax_build
from transformer_transducer_tpu.parallel import mesh as jax_mesh
from transformer_transducer_tpu.parallel.sequence import (
    encode_banded_sp as jax_encode_banded_sp, encode_banded_sp_espnet as jax_sp_espnet,
    encode_banded_sp_oracle as jax_sp_oracle, seq_mesh)
from transformer_transducer_tpu.training import optim as jax_optim
from transformer_transducer_tpu.training.train_step import (
    TrainStepConfig as JaxStepConfig, compile_train_step)
from transformer_transducer_tpu.utils.config import Config as JaxConfig
from transformer_transducer_tpu.utils.torch_convert import (
    espnet_transducer_params, transducer_params)
from transformer_transducer_tpu_torch.apps import train as train_app
from transformer_transducer_tpu_torch.models.factory import build_family
from transformer_transducer_tpu_torch.models.transducer import build_transducer
from transformer_transducer_tpu_torch.parallel.mesh import Mesh, default_n_data, make_mesh
from transformer_transducer_tpu_torch.parallel.sequence import (
    encode_banded_sp, encode_banded_sp_espnet, encode_banded_sp_oracle, pinned_window_len)
from transformer_transducer_tpu_torch.training.optim import build_optimizer
from transformer_transducer_tpu_torch.training.train_step import (
    TrainStepConfig, batch_to_device, make_seq_loss_fn, make_train_step, states_loss)
from transformer_transducer_tpu_torch.training.trainer import Trainer
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.config import Config, dump_config
from transformer_transducer_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

ENC_TOL = dict(rtol=1e-5, atol=1e-5)          # tests/test_sequence_parallel.py
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
W = 64                                         # the pinned window of JAX's tests
# (shards, (left, right)) of the native encodes: 2 and 4 shards, and the
# edge bands left = 0 and right = 0 (JAX's test_sp_left_zero / right_zero)
ENCODES = [(2, (4, 2)), (4, (4, 2)), (4, (0, 2)), (4, (4, 0))]
SP_WINDOW = 64                                 # the steps' sp_window


def _x(b=2, t=32, seed=0):
    return np.random.RandomState(seed).randn(b, t, 64).astype(np.float32)


def _espnet_x(seed=4, b=4, t=24, d=32):
    rng = np.random.RandomState(seed)
    return rng.randn(b, t, d).astype(np.float32), np.array([t - 3 * i for i in range(b)])


def _steps_case(cfg, state, batch, n_data=2, n_model=1, banded=True, **kw):
    return {"kind": "steps", "model_cfg": cfg, "banded": banded, "state": state,
            "batch": batch, "optim": SGD, "zero": False, "n_data": n_data,
            "n_model": n_model, "n_seq": 2, "sp_window": SP_WINDOW, "steps": 3, **kw}


def _jax_sp(model_j, variables, batch, n_data, n_model, pruned=None, espnet=False):
    """JAX's (data n_data, model n_model, seq 2) mesh: 3 SGD steps of the sp
    train step on the same weights and batch (no SpecAugment, dropout 0);
    the losses and the parameters in the port's names."""
    mesh = jax_mesh.make_mesh(n_data=n_data, n_model=n_model, n_seq=2,
                              devices=jax.devices()[:2 * n_data * n_model])
    tx = jax_optim.build_optimizer(JaxConfig(dict(SGD)), 200.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt = tx.init(params)
    step_cfg = JaxStepConfig(specaug=False, n_seq=2, sp_window=0 if espnet else SP_WINDOW,
                             loss_pruned_range=pruned)
    step = compile_train_step(model_j, tx, mesh, params, opt, step_cfg, donate=False)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(3):
        params, opt, m = step(params, opt, jax_mesh.shard_batch(batch, mesh),
                              jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return losses, from_jax_params(jax.device_get(params))


def _jax_encodes(model_j, variables, esp, conv):
    """JAX's sp encoder at each of ``ENCODES`` and its oracle at 4 shards,
    and its espnet sp encoder on 4 shards (ragged lengths) and, with a
    conv2d input layer, on 2; each SPMD program jitted."""
    x = jnp.asarray(_x())
    ref = {}
    for n, (left, right) in ENCODES:
        mesh = seq_mesh(n, devices=jax.devices()[:n])
        run = jax.jit(lambda v, x: jax_encode_banded_sp(model_j, v, x, mesh, left, right,
                                                        window_len=W))
        ref[n, left, right] = np.asarray(run(variables, x))
    ref["jax_oracle"] = np.asarray(jax_sp_oracle(model_j, variables, x, 4, 4, 2, window_len=W))
    for key, (model, variables_e), (xs, lens), n in (("espnet", esp, _espnet_x(), 4),
                                                     ("conv", conv, _conv_x(), 2)):
        mesh = seq_mesh(n, devices=jax.devices()[:n])
        run = jax.jit(lambda p, x, l: jax_sp_espnet(model, p, x, l, mesh))
        out, out_len = run(variables_e["params"], jnp.asarray(xs), jnp.asarray(lens))
        ref[key + "_encode"] = (np.asarray(out), np.asarray(out_len))
    return ref


def _weights(model_cfg, espnet=False, seed=0):
    """``(port state, JAX variables)`` of one set of seeded weights: the
    port's model built from ``torch.manual_seed(seed)`` and its state dict
    through the JAX package's ``utils/torch_convert.py`` (no flax init)."""
    torch.manual_seed(seed)
    if espnet:
        model = build_family(Config({"model": copy.deepcopy(model_cfg)}), device="cpu")
    else:
        model = build_transducer(Config(copy.deepcopy(model_cfg)), device="cpu")
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    part = {c: {k[len(c) + 1:]: v.numpy() for k, v in state.items() if k.startswith(c + ".")}
            for c in ("encoder", "decoder", "joint")}
    convert = espnet_transducer_params if espnet else transducer_params
    return state, convert(part["encoder"], part["decoder"], part["joint"])


def _conv_x(seed=5, b=3, t=51):
    rng = np.random.RandomState(seed)
    return rng.randn(b, t, 16).astype(np.float32), np.array([t, t - 7, t - 20])


def _oracle_steps(cfg, state, batch, pruned=None):
    """One process: 3 SGD steps whose encoder is the 2-shard oracle (the
    pinned-window function sp2 trains), autograd through it."""
    model = build_transducer(Config(copy.deepcopy(cfg)), banded=True, device="cpu")
    model.load_state_dict(state)
    model.train()
    opt = build_optimizer(Config(dict(SGD)), list(model.parameters()), max_grad_norm=200.0)
    step_cfg = TrainStepConfig(specaug=False, loss_pruned_range=pruned)
    dev = batch_to_device(batch, "cpu")
    losses = []
    for _ in range(3):
        for p in opt.params:
            p.grad = None
        enc = encode_banded_sp_oracle(model, dev["inputs"], 2, *model.band, SP_WINDOW)
        dec = model.encode_labels(dev["targets"], dev["targets_length"])
        loss = states_loss(model, step_cfg, enc, dec, dev, dev["inputs_length"])
        loss.backward()
        opt.step([p.grad for p in opt.params])
        losses.append(float(loss.detach()))
    return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}


def _one_process_espnet(cfg, state, batch):
    model = build_family(Config({"model": copy.deepcopy(cfg)}), device="cpu")
    model.load_state_dict(state)
    model.train()
    opt = build_optimizer(Config(dict(SGD)), list(model.parameters()), max_grad_norm=200.0)
    step = make_train_step(model, opt, TrainStepConfig(specaug=False))
    losses = [float(step(batch_to_device(batch, "cpu"), None)["loss"]) for _ in range(3)]
    return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank run: the native encoder on 4 shards (and at ``left`` 0
    and ``right`` 0) and its gradients, the espnet encoder with ragged
    lengths, the meshes of the dp2 x sp2, tp2 x sp2 and sp4 grids, and 3
    steps each of dp2 x sp2 (full, pruned, espnet, ZeRO-1) and tp2 x sp2
    (full, pruned).  The 2-rank run: ``apps/train.py --banded --n_seq 2``
    for one epoch of a tone corpus, then in its group the native encoder on
    2 shards and the espnet encoder with a conv2d input layer.  Meanwhile,
    here: JAX's references in threads and the one-process runs; after both
    runs one process loads the CLI's checkpoint and evaluates it."""
    root = tmp_path_factory.mktemp("sp")
    cfg = tiny_model_cfg(vocab=V)
    esp_cfg = tiny_espnet_cfg(vocab=40, d=32)
    conv_cfg = tiny_espnet_cfg("conv2d", vocab=40, d=32, d_in=16)
    states, jax_vars = {}, {}
    for name, c in (("native", cfg), ("espnet", esp_cfg), ("conv", conv_cfg)):
        states[name], jax_vars[name] = _weights(c, espnet=name != "native")
    state, esp_state, conv_state = states["native"], states["espnet"], states["conv"]
    variables = jax_vars["native"]
    model_j = jax_build(JaxConfig(copy.deepcopy(cfg)), banded=True)
    esp_j = (jax_build_espnet(JaxConfig(copy.deepcopy(esp_cfg))), jax_vars["espnet"])
    conv_j = (jax_build_espnet(JaxConfig(copy.deepcopy(conv_cfg))), jax_vars["conv"])
    vocab, csvs = make_tone_corpus(str(root / "corpus"), n_train=12, n_dev=6)
    train_cfg = Config(tiny_train_config(str(root / "corpus"), vocab, csvs, n_enc=2).to_dict())
    cfg_path = str(root / "tiny.yaml")
    dump_config(train_cfg, cfg_path)
    sp_dir = root / "sp_cli"
    for d in (sp_dir, root / "w2", root / "w4"):
        d.mkdir()

    def enc(n, band, **kw):
        return {"kind": "sp_encode", "model_cfg": cfg, "state": state, "x": _x(),
                "n_seq": n, "band": band, "window": W, **kw}
    esp_x, esp_len = _espnet_x()
    conv_x, conv_len = _conv_x()
    cases4 = [
        *(enc(n, band) for n, band in ENCODES[1:]),
        enc(4, (4, 2), grad=True, x=_x(t=16), window=None),
        {"kind": "sp_encode", "model_cfg": esp_cfg, "state": esp_state, "x": esp_x,
         "lengths": esp_len, "n_seq": 4},
        {"kind": "mesh", "n_data": 2, "n_seq": 2},
        {"kind": "mesh", "n_model": 2, "n_seq": 2},
        {"kind": "mesh", "n_seq": 4},
        _steps_case(cfg, state, _batch()),
        _steps_case(cfg, state, _batch(), pruned=3),
        _steps_case(esp_cfg, esp_state, _espnet_batch(), banded=False, sp_window=0),
        _steps_case(cfg, state, _batch(), zero=True),
        _steps_case(cfg, state, _batch(), n_data=1, n_model=2),
        _steps_case(cfg, state, _batch(), n_data=1, n_model=2, pruned=3),
    ]
    argv = ["-config", cfg_path, "--device", "cpu", "--epochs", "1"]
    cases2 = [
        {"kind": "cli", "cwd": str(sp_dir), "argv": argv + ["--banded", "--n_seq", "2"]},
        enc(*ENCODES[0]),
        {"kind": "sp_encode", "model_cfg": conv_cfg, "state": conv_state, "x": conv_x,
         "lengths": conv_len, "n_seq": 2},
    ]
    started = [start_ranks(4, cases4, root / "w4"), start_ranks(2, cases2, root / "w2")]
    # JAX's work in threads (its compiles leave the interpreter lock)
    pool = ThreadPoolExecutor(4)
    try:
        jobs = {"encodes": pool.submit(_jax_encodes, model_j, variables, esp_j, conv_j),
                "dp_full": pool.submit(_jax_sp, model_j, variables, _batch(), 2, 1),
                "dp_pruned": pool.submit(_jax_sp, model_j, variables, _batch(), 2, 1, 3),
                "tp_full": pool.submit(_jax_sp, model_j, variables, _batch(), 1, 2),
                "tp_pruned": pool.submit(_jax_sp, model_j, variables, _batch(), 1, 2, 3),
                "espnet": pool.submit(_jax_sp, *esp_j, _espnet_batch(), 2, 1, espnet=True)}
        ref = {"oracle": _oracle_steps(cfg, state, _batch()),
               "oracle_pruned": _oracle_steps(cfg, state, _batch(), pruned=3),
               "one_espnet": _one_process_espnet(esp_cfg, esp_state, _espnet_batch()),
               "states": states}
        for name, job in jobs.items():
            ref[name] = job.result()
        ref.update(ref.pop("encodes"))
    finally:
        pool.shutdown()
        ranks4 = join_ranks(started[0])
        ranks2 = join_ranks(started[1])
    # one process loads the CLI's checkpoint and evaluates it
    exp = os.path.join(str(sp_dir), ranks2[0][0]["exp_dir"])
    cwd = os.getcwd()
    try:
        os.chdir(root)
        one_cfg = copy.deepcopy(train_cfg)
        one_cfg.override("training.load_model", os.path.join(exp, "epoch_0"))
        one = Trainer(one_cfg, exp_root=str(root / "one"), banded=True, device="cpu")
        _, dev = one.make_loaders()
        ref["one_cer"] = one.evaluate(0, dev)
        ref["one_model"] = one.model
    finally:
        os.chdir(cwd)
    ref.update(exp=exp, cfg=cfg, esp_cfg=esp_cfg, conv_cfg=conv_cfg)
    return ranks4, ranks2, ref


# case indices of the 4-rank run
SP4_GRAD, SP4_ESPNET, MESH_DP, MESH_TP, MESH_SP4 = 3, 4, 5, 6, 7
DP_FULL, DP_PRUNED, DP_ESPNET, DP_ZERO, TP_FULL, TP_PRUNED = range(8, 14)
# ... and of the 2-rank run
CLI, SP2_NATIVE, SP2_CONV = range(3)


@pytest.mark.parametrize("n, band", ENCODES)
def test_encode_banded_sp_matches_jax(n, band, runs):
    """The whole encoding on every shard against JAX's ``encode_banded_sp``
    on ``seq_mesh(n)`` and the port's one-process oracle (and at 4 shards
    and band (4, 2) JAX's ``encode_banded_sp_oracle``), pinned window 64;
    ``left`` 0 slices no whole shard, ``right`` 0 exchanges no right
    halo."""
    ranks4, ranks2, ref = runs
    if n == 2:
        outs = [r[SP2_NATIVE]["out"] for r in ranks2]
    else:
        index = ENCODES[1:].index((n, band))
        outs = [r[index]["out"] for r in ranks4]
    model = build_transducer(Config(copy.deepcopy(ref["cfg"])), banded=True, device="cpu")
    model.load_state_dict(ref["states"]["native"])
    with torch.no_grad():
        oracle = encode_banded_sp_oracle(model.eval(), torch.from_numpy(_x()), n, *band, W)
    for out in outs:
        np.testing.assert_allclose(out.numpy(), ref[(n, *band)], **ENC_TOL)
        np.testing.assert_allclose(out.numpy(), oracle.numpy(), **ENC_TOL)
        if (n, band) == (4, (4, 2)):         # tests/test_sequence_parallel.py's case
            np.testing.assert_allclose(out.numpy(), ref["jax_oracle"], **ENC_TOL)
        assert torch.equal(out, outs[0])


def test_sp_is_invariant_in_the_shard_count(runs):
    """With the window pinned, 1, 2 and 4 shards give one function: the
    2- and 4-shard runs against the port's one-process oracle at 1 shard."""
    ranks4, ranks2, ref = runs
    model = build_transducer(Config(copy.deepcopy(ref["cfg"])), banded=True, device="cpu")
    model.load_state_dict(ref["states"]["native"])
    with torch.no_grad():
        one = encode_banded_sp_oracle(model.eval(), torch.from_numpy(_x()), 1, 4, 2, W)
        alone = encode_banded_sp(model, torch.from_numpy(_x()), Mesh(), 4, 2, W)
    assert torch.equal(one, alone)
    for out in (ranks2[0][SP2_NATIVE]["out"], ranks4[0][0]["out"]):
        np.testing.assert_allclose(out.numpy(), one.numpy(), **ENC_TOL)


def test_sp_backward_matches_autograd_through_the_oracle(runs):
    """The encoder's gradients of ``sum(h ** 2)`` through 4 shards (the
    halos' backward adding each neighbour's gradient into the rows it
    sent), summed over the seq group, against autograd through the
    one-process oracle; every shard holds the same sums."""
    ranks4, _, ref = runs
    model = build_transducer(Config(copy.deepcopy(ref["cfg"])), banded=True, device="cpu")
    model.load_state_dict(ref["states"]["native"])
    model.eval()
    x = torch.from_numpy(_x(t=16))
    (encode_banded_sp_oracle(model, x, 4, 4, 2, pinned_window_len(4, 4, 2)) ** 2).sum().backward()
    want = {n: p.grad for n, p in model.named_parameters() if n.startswith("encoder.")}
    for r in ranks4:
        got = r[SP4_GRAD]["grads"]
        assert set(got) == set(want)
        for n, g in want.items():
            np.testing.assert_allclose(got[n].numpy(), g.numpy(), err_msg=n, **GRAD_TOL)
            assert torch.equal(got[n], ranks4[0][SP4_GRAD]["grads"][n]), n


@pytest.mark.parametrize("name", ["espnet", "conv"])
def test_espnet_sp_encode_matches_jax(name, runs):
    """The espnet encoder on 4 shards with ragged lengths (the key mask at
    the window edges), and with a conv2d input layer on 2 shards (the
    model-rate axis split after the subsampling): JAX's
    ``encode_banded_sp_espnet``, and the port's one-process ``encode``,
    which the espnet sp encoder equals; the lengths mapped alike."""
    ranks4, ranks2, ref = runs
    outs = ([r[SP4_ESPNET] for r in ranks4] if name == "espnet"
            else [r[SP2_CONV] for r in ranks2])
    xs, lens = _espnet_x() if name == "espnet" else _conv_x()
    model = build_family(Config({"model": copy.deepcopy(ref[f"{name}_cfg" if name == "conv"
                                                             else "esp_cfg"])}), device="cpu")
    model.load_state_dict(ref["states"][name])
    with torch.no_grad():
        one = model.eval().encode(torch.from_numpy(xs), torch.from_numpy(lens))
    want, want_len = ref[name + "_encode"]
    for got in outs:
        np.testing.assert_allclose(got["out"].numpy(), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["out"].numpy(), one.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(got["lengths"]), want_len)


@pytest.mark.parametrize("name", ["dp_full", "dp_pruned", "tp_full", "tp_pruned", "espnet"])
def test_sp_steps_match_the_jax_sp_mesh(name, runs):
    """dp2 x sp2 and tp2 x sp2 steps (full and pruned loss) and espnet dp2
    x sp2 against JAX's sp train step on the same grid, 3 SGD steps: the
    losses on every rank and the whole model's parameters."""
    ranks4, _, ref = runs
    index = {"dp_full": DP_FULL, "dp_pruned": DP_PRUNED, "tp_full": TP_FULL,
             "tp_pruned": TP_PRUNED, "espnet": DP_ESPNET}[name]
    losses_j, params_j = ref[name]
    for r in ranks4:
        got = r[index]
        np.testing.assert_allclose(got["loss"], losses_j, **LOSS_TOL)
        assert set(got["params"]) == set(params_j)
        for k, v in params_j.items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), err_msg=k,
                                       **TREE_TOL)
        assert got["loss"] == ranks4[0][index]["loss"]


@pytest.mark.parametrize("name", ["dp_full", "dp_pruned", "tp_full", "espnet"])
def test_sp_steps_match_one_process(name, runs):
    """The same steps against the port's one process: the native family's
    step with the 2-shard oracle as its encoder (the pinned-window function
    sp2 trains), the espnet family's plain step (its sp encoder is exact)."""
    ranks4, _, ref = runs
    index = {"dp_full": DP_FULL, "dp_pruned": DP_PRUNED, "tp_full": TP_FULL,
             "espnet": DP_ESPNET}[name]
    losses, params = ref[{"dp_pruned": "oracle_pruned", "espnet": "one_espnet"}.get(
        name, "oracle")]
    for r in ranks4:
        np.testing.assert_allclose(r[index]["loss"], losses, **LOSS_TOL)
        for k, v in params.items():
            np.testing.assert_allclose(r[index]["params"][k].numpy(), v.numpy(), err_msg=k,
                                       **TREE_TOL)


def test_zero_on_the_data_seq_grid(runs):
    """ZeRO-1 on dp2 x sp2: losses, norms and parameters to the bit of the
    same grid without it; the seq ranks of a data index hold the same
    moment slices, and the gathered moments are whole."""
    ranks4, _, _ = runs
    for r in ranks4:
        plain, zero = r[DP_FULL], r[DP_ZERO]
        assert plain["loss"] == zero["loss"] and plain["grad_norm"] == zero["grad_norm"]
        for k, v in plain["params"].items():
            assert torch.equal(v, zero["params"][k]), k
        for key, moments in plain["state_dict"]["state"].items():
            assert all(torch.equal(a, b) for a, b in
                       zip(moments, zero["state_dict"]["state"][key])), key
        assert zero["slices"] is not None and any(s is not None for s in zero["slices"])
    for d in range(2):
        a, b = (r[DP_ZERO] for r in ranks4 if r[DP_ZERO]["data_rank"] == d)
        assert all(torch.equal(x, y) for x, y in zip(a["moments"]["trace"],
                                                    b["moments"]["trace"]))


@pytest.mark.parametrize("grid", ["dp2 x sp2", "tp2 x sp2", "sp4"])
def test_make_mesh_puts_seq_minor(grid, runs):
    """JAX's ``make_mesh(n_data, n_model, n_seq=...)`` layout: rank r at data
    index r // (n_model * n_seq), model index r // n_seq % n_model, seq
    index r % n_seq; a seq group a (data, model) index with links between
    adjacent shards, a model group a (data, seq) index, a data group a
    (model, seq) index."""
    ranks4, _, _ = runs
    n_data, n_model, n_seq, index = {"dp2 x sp2": (2, 1, 2, MESH_DP),
                                     "tp2 x sp2": (1, 2, 2, MESH_TP),
                                     "sp4": (1, 1, 4, MESH_SP4)}[grid]
    devices = jax.devices()[:4]
    grid_j = jax_mesh.make_mesh(n_data=n_data, n_model=n_model, n_seq=n_seq, devices=devices)
    ids = [d.id for d in devices]
    place = {ids.index(d.id): idx for idx, d in np.ndenumerate(grid_j.devices)}
    for rank, r in enumerate(ranks4):
        m = r[index]
        d, mi, s = place[rank][0], place[rank][1], place[rank][-1]
        assert (m["data_rank"], m["model_rank"], m["seq_rank"]) == (d, mi, s)
        assert m["shape"] == dict(grid_j.shape)
        base = rank - s
        assert m["seq_group"] == list(range(base, base + n_seq)) == list(m["seq_ranks"])
        assert m["prev_seq_link"] == (None if s == 0 else [rank - 1, rank])
        assert m["next_seq_link"] == (None if s == n_seq - 1 else [rank, rank + 1])
        assert m["model_group"] == (None if n_model == 1 else
                                    [d * 4 + k * n_seq + s for k in range(n_model)])
        assert m["data_group"] == (None if n_data == 1 else [s, s + 2])
        assert m["data_root"] == rank % (n_model * n_seq)
        assert m["is_main"] == (rank == 0)


@pytest.mark.parametrize("batch, world, n_model, n_seq", [
    (8, 4, 1, 2), (8, 8, 2, 2), (6, 8, 1, 2), (4, 2, 1, 2), (8, 8, 1, 4)])
def test_default_data_axis_counts_the_seq_axis(batch, world, n_model, n_seq):
    """JAX's default data axis (``training/trainer.py:146-151``): the
    largest divisor of the batch at most the world over ``n_model *
    n_seq``."""
    avail = world // (n_model * n_seq)
    want = max(d for d in range(1, avail + 1) if batch % d == 0)
    assert default_n_data(batch, n_model, world=world, n_seq=n_seq) == want


def test_pinned_window_len():
    """JAX's rule: the shard plus halos rounded up to 64; the flagship's
    2-shard window is 256 rows."""
    assert pinned_window_len(10, 52, 2) == 64
    assert pinned_window_len(10, 53, 2) == 128
    assert pinned_window_len(10, 205, 2) == 256


def _validation_cer(log_path):
    lines = [l for l in open(log_path, encoding="utf-8") if "-Validation-" in l]
    return float(lines[0].split("CER: ")[1].split()[0])


def test_cli_trains_sp2_and_one_process_evaluates_its_checkpoint(runs):
    """``apps/train.py --banded --n_seq 2`` over 2 ranks: one data rank,
    rank 0 alone writes the log (with the shards' geometry), an
    ``epoch_0`` that holds the whole model and moments, which one process
    loads (equal to each rank's weights) and evaluates to the CER of the
    run's validation line."""
    _, ranks2, ref = runs
    cli = [r[CLI] for r in ranks2]
    assert [(c["n_seq"], c["n_data"]) for c in cli] == [(2, 1)] * 2
    assert cli[0]["global_step"] == cli[1]["global_step"] == 3
    exp = ref["exp"]
    assert [f for f in os.listdir(exp) if f.endswith(".log")] == ["train.log"]
    log = open(os.path.join(exp, "train.log"), encoding="utf-8").read()
    assert "'seq': 2" in log and "Sequence: 2 shards of 12 frames, band (4, 2), " \
        "windows of 64 rows" in log
    state = ckpt_lib.load_checkpoint(os.path.join(exp, "epoch_0"), "cpu")
    one = ref["one_model"].state_dict()
    for comp in ckpt_lib.COMPONENTS:
        for k, v in state[comp].items():
            assert torch.equal(v, one[f"{comp}.{k}"]), k
            assert all(torch.equal(v, c["local"][f"{comp}.{k}"]) for c in cli), k
    for t, p in zip(state["optimizer"]["state"]["trace"], one.values()):
        assert t.shape == p.shape
    assert _validation_cer(os.path.join(exp, "train.log")) == ref["one_cer"]


def _tiny_native(**kw):
    return build_transducer(Config(tiny_model_cfg(vocab=V)), device="cpu", **kw)


@pytest.mark.parametrize("what", ["pick one", "banded", "divide", "halo", "window_len",
                                  "espnet band", "generator", "trainer pick one",
                                  "trainer banded", "trainer divide", "trainer halo",
                                  "cli pick one"])
def test_errors_as_jax(what, tmp_path):
    """JAX's checks and messages: ``n_pipe`` with ``n_seq`` (pick one), a
    native model that does not train banded, T that does not divide over
    the shards, a shard that does not cover the halo, a window shorter
    than the shard and its halos, an espnet model without a finite band,
    train mode without a dropout generator; the trainer's and the CLI's
    alike.  Each raises before any collective."""
    x = torch.from_numpy(_x())
    mesh4 = Mesh(n_seq=4, seq_ranks=(0, 1, 2, 3))
    if what == "pick one":
        with pytest.raises(ValueError, match="pick one"):
            make_mesh(n_pipe=2, n_seq=2)
    elif what == "banded":
        with pytest.raises(ValueError, match="needs banded training"):
            make_seq_loss_fn(_tiny_native(), TrainStepConfig(), mesh4)
    elif what in ("divide", "halo", "window_len"):
        model = _tiny_native(banded=True).eval()
        args = {"divide": (x[:, :30], mesh4, 4, 2, W),
                "halo": (x, Mesh(n_seq=8, seq_ranks=tuple(range(8))), 5, 2, W),
                "window_len": (x, mesh4, 4, 2, 8)}[what]
        match = {"divide": "T=30 must divide over 4 shards",
                 "halo": r"shard 4 must cover the halo \(left 5 / right 2\)",
                 "window_len": "window_len 8 < left\\+shard\\+right 14"}[what]
        with pytest.raises(ValueError, match=match):
            encode_banded_sp(model, *args)
    elif what == "espnet band":
        cfg = tiny_espnet_cfg(vocab=40, d=32, band=(-1, 2, 2))
        model = build_family(Config({"model": cfg}), device="cpu").eval()
        with pytest.raises(ValueError, match="needs a finite band"):
            encode_banded_sp_espnet(model, torch.zeros(2, 24, 32), None, mesh4)
    elif what == "generator":
        with pytest.raises(ValueError, match="requires a dropout_rng"):
            encode_banded_sp(_tiny_native(banded=True).train(), x, mesh4, 4, 2)
    elif what.startswith("trainer"):
        vocab, csvs = make_tone_corpus(str(tmp_path / "corpus"), n_train=4, n_dev=2)
        cfg = Config(tiny_train_config(str(tmp_path / "corpus"), vocab, csvs,
                                       n_enc=2).to_dict())
        kw, match = {
            "trainer pick one": ({"n_pipe": 2, "n_seq": 2, "banded": True}, "pick one"),
            "trainer banded": ({"n_seq": 2}, "needs banded training"),
            "trainer divide": ({"n_seq": 5, "banded": True},
                               "model-rate max length 24 must divide over 5"),
            "trainer halo": ({"n_seq": 8, "banded": True},
                             r"sequence shard 3 must cover the band halo \(4, 2\)")}[what]
        with pytest.raises(ValueError, match=match):
            Trainer(cfg, exp_root=str(tmp_path / "egs"), device="cpu", **kw)
    else:
        with pytest.raises(ValueError, match="pick one"):
            train_app.main(["--device", "cpu", "--n_pipe", "2", "--n_seq", "2"])
