"""PyTorch port: the JAX package's checkpoints read without flax
(``utils/flax_msgpack.py``, ``utils/checkpoint.py``, ``utils/convert.py``).

The JAX package writes checkpoints here (``save_checkpoint``,
``save_partial_checkpoint``, its trainer's ``epoch_*`` and ``step_*``);
the port reads every leaf bit-equal to ``flax.serialization``, serves them
with the JAX tokens, and continues training from them: one port step after
``-mode continue`` gives the parameters of one JAX step after its own
continue within rtol 2e-4, atol 2e-5 (``TOL``).  The msgpack reader is held
against ``msgpack.packb`` on every type it decodes, and ``chip_smoke.py``'s
writer against ``flax.serialization.to_bytes``."""

import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
import flax.serialization as flax_ser

import chip_smoke
from data_helpers import make_corpus, tiny_train_config
from transformer_transducer_tpu.decoding.greedy import recognize as jax_recognize
from transformer_transducer_tpu.ops.masks import context_mask as jax_context_mask
from transformer_transducer_tpu.parallel import mesh as mesh_lib
from transformer_transducer_tpu.training import optim as jax_optim
from transformer_transducer_tpu.training.trainer import Trainer as JaxTrainer
from transformer_transducer_tpu.utils import checkpoint as jax_ckpt
from transformer_transducer_tpu_torch.decoding.greedy import recognize
from transformer_transducer_tpu_torch.models.factory import load_family
from transformer_transducer_tpu_torch.training.train_step import batch_to_device
from transformer_transducer_tpu_torch.training.trainer import Trainer
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils import flax_msgpack
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.convert import (
    from_jax_params, optimizer_from_jax)

from torch_port_helpers import TOL, jax_model, t, tiny_model_cfg

torch.set_num_threads(1)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _assert_same_tree(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert list(got) == list(ref)
    for path, r in ref.items():
        g = got[path]
        if isinstance(g, torch.Tensor):      # bfloat16 leaves
            assert str(np.asarray(r).dtype) == "bfloat16", path
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  np.asarray(r).view(np.int16)), path
        elif isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and g.shape == r.shape, path
            assert g.tobytes() == r.tobytes(), path
        else:
            assert type(g) is type(r) and g == r, path


@pytest.fixture(scope="module")
def variables():
    _, v = jax_model(tiny_model_cfg(), seed=1)
    return v


@pytest.mark.parametrize("partial", [False, True])
def test_reader_is_bit_equal_to_flax(tmp_path, variables, partial):
    """Every leaf the JAX ``save_checkpoint`` / ``save_partial_checkpoint``
    writes (weights, and an adam state with its int32 counts) reads back
    bit-equal to ``flax.serialization.msgpack_restore``; a bfloat16 leaf as
    a ``torch.bfloat16`` tensor of the same bits."""
    params = dict(variables["params"])
    params["joint"] = dict(params["joint"], extra=jnp.linspace(-3, 3, 7, dtype=jnp.bfloat16))
    cfg = Config({"type": "adam", "lr": 1e-3})
    opt = jax.jit(jax_optim.build_optimizer(cfg, max_grad_norm=200).init)(params)
    if partial:
        jax_ckpt.save_partial_checkpoint(str(tmp_path), params, ["encoder", "joint"],
                                         opt_state=opt, epoch=3, step=7)
        comps = ["encoder", "joint"]
    else:
        jax_ckpt.save_checkpoint(str(tmp_path), params, opt, epoch=3, step=7)
        comps = ["encoder", "decoder", "joint", "optimizer"]
    for comp in comps:
        path = str(tmp_path / f"{comp}.msgpack")
        with open(path, "rb") as fh:
            ref = flax_ser.msgpack_restore(fh.read())
        _assert_same_tree(flax_msgpack.read_file(path), ref)
    meta = json.load(open(tmp_path / "meta.json"))
    assert (meta["epoch"], meta["step"]) == (3, 7)
    assert ckpt_lib.is_jax_checkpoint(str(tmp_path))
    want = from_jax_params(variables["params"])
    enc = ckpt_lib.load_component(str(tmp_path), "encoder")
    assert enc and all(torch.equal(v, want["encoder." + k]) for k, v in enc.items())
    if partial:
        with pytest.raises(FileNotFoundError, match="decoder"):
            ckpt_lib.load_checkpoint(str(tmp_path))


@pytest.mark.parametrize("mode", ["band", "full_context"])
def test_load_family_serves_jax_tokens(tmp_path, mode):
    """A checkpoint the JAX package saved, through the port's
    ``load_family`` and ``recognize``, gives the JAX ``recognize`` tokens."""
    from test_torch_port_greedy import SECONDS, _batch, _emitting_variables, _features, _wave
    from transformer_transducer_tpu.ops import features_np as jax_F
    from transformer_transducer_tpu_torch.ops import features_np as F
    cfg = tiny_model_cfg()
    flash = mode == "full_context"
    jm, variables = jax_model(cfg, flash=flash, seed=3)
    waves = [_wave(s, seed=i) for i, s in enumerate(SECONDS)]
    x, t_len = _batch([_features(F, w) for w in waves])
    jx, jt_len = _batch([_features(jax_F, w) for w in waves])
    variables = _emitting_variables(variables, x, cfg)
    jax_ckpt.save_checkpoint(str(tmp_path), variables["params"], epoch=0, step=5)
    model = load_family(Config({"model": cfg}), 64, str(tmp_path), device="cpu", flash=flash)
    got = recognize(model, t(x), t_len, band=None if flash else (10, 2))
    mask = None if flash else jax_context_mask(x.shape[1], 10, 2)
    ref = jax_recognize(jm, variables, jnp.asarray(jx), jnp.asarray(jt_len), audio_mask=mask)
    assert got == ref
    assert 0 < sum(map(len, got)) < int(t_len.sum())


# ---------------------------------------------------------------------------
# -mode continue from the JAX trainer's checkpoints

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_ckpt_corpus"))
    return make_corpus(root, n_train=8, n_dev=4)[0:2] + (root,)


def _train_cfg(corpus, kind, **overrides):
    vocab_path, csvs, root = corpus
    cfg = tiny_train_config(root, vocab_path, csvs, n_enc=2, d_model=64)
    cfg.override("training.specaug", False)
    cfg.override("optim.type", kind)
    cfg.override("optim.lr", 0.01 if kind == "sgd" else 2e-3)
    for key, value in overrides.items():
        cfg.override(key, value)
    return cfg


def _jax_step(trainer, batch):
    trainer.rng, rng = jax.random.split(trainer.rng)
    trainer.params, trainer.opt_state, _ = trainer.train_step(
        trainer.params, trainer.opt_state, mesh_lib.shard_batch(batch, trainer.mesh), rng)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_continue_from_jax_epoch_matches_a_jax_step(corpus, tmp_path, kind):
    """The JAX trainer trains epoch 0 (momentum 0.9 / adam moments), decays
    the rate and saves ``epoch_0``; the port's ``-mode continue`` restores
    the weights, the optimizer state, the rate and the counters, and its
    first step equals the JAX trainer's first step after its own continue."""
    cfg = _train_cfg(corpus, kind)
    exp_root = str(tmp_path / "egs")
    first = JaxTrainer(cfg, exp_root=exp_root)
    loader, _ = first.make_loaders()
    first.train_epoch(0, loader)
    first.lr_ctl.maybe_decay(0)           # what fit does before saving
    first.opt_state = jax_optim.set_learning_rate(first.opt_state, first.lr_ctl.lr)
    first.save(0)
    del first

    jc = JaxTrainer(cfg, mode="continue", exp_root=exp_root)
    pc = Trainer(Config(cfg.to_dict()), mode="continue", exp_root=exp_root, device="cpu")
    assert (pc.start_epoch, pc.global_step) == (jc.start_epoch, jc.global_step) == (1, 2)
    assert pc.lr_ctl.lr == jc.lr_ctl.lr == pytest.approx(cfg.optim.lr * 0.5)
    assert pc.optimizer.lr == pytest.approx(jax_optim.get_learning_rate(jc.opt_state))
    assert pc.optimizer.count == 2
    assert set(pc.optimizer.state) == ({"trace"} if kind == "sgd" else {"mu", "nu"})
    start = from_jax_params(jax.device_get(jc.params))
    for name, p in pc.model.named_parameters():
        assert torch.equal(p.detach(), start[name]), name

    loader, _ = jc.make_loaders()
    loader.epoch = 1
    batch = next(iter(loader))
    _jax_step(jc, batch)
    pc.train_step(batch_to_device(batch, "cpu"), pc.gen)
    want = from_jax_params(jax.device_get(jc.params))
    moved = 0.0
    for name, p in pc.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
        moved = max(moved, float((want[name] - start[name]).abs().max()))
    assert moved > 1e-4, "the step moved the parameters"


def test_continue_from_jax_step_checkpoint(corpus, tmp_path):
    """A JAX ``step_*`` checkpoint (``training.save_every_steps``) resumes
    mid-epoch at the JAX trainer's position; its JAX random key cannot be
    used, and the log says that dropout and SpecAugment are re-seeded."""
    cfg = _train_cfg(corpus, "sgd", **{"training.save_every_steps": 1})
    exp_root = str(tmp_path / "egs")
    first = JaxTrainer(cfg, exp_root=exp_root)
    loader, _ = first.make_loaders()
    for i, batch in enumerate(loader):       # one batch, then the process stops
        _jax_step(first, batch)
        first.global_step += 1
        first.save_step(0, i + 1)
        break
    step_dir = ckpt_lib.latest_checkpoint(first.exp_dir)
    assert os.path.basename(step_dir) == "step_1"
    pc = Trainer(Config(cfg.to_dict()), mode="continue", exp_root=exp_root, device="cpu")
    assert (pc.start_epoch, pc._resume_batches, pc.global_step) == (0, 1, 1)
    assert pc.optimizer.count == 1
    want = from_jax_params(jax.device_get(first.params))
    for name, p in pc.model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
    log = open(os.path.join(pc.exp_dir, "train.log"), encoding="utf-8").read()
    assert "re-seeded from training.seed" in log


def test_load_model_encoder_and_decoder_from_jax(tmp_path, corpus):
    """``training.load_model``, ``load_encoder`` and ``load_decoder`` take
    JAX directories, a partial one (``save_partial_checkpoint``) too."""
    from transformer_transducer_tpu.models.transducer import build_transducer as jax_build
    cfg = _train_cfg(corpus, "sgd")
    params = jax_build(cfg.model).init(jax.random.PRNGKey(7), jnp.zeros((1, 8, 64)),
                                       jnp.zeros((1, 4), jnp.int32))["params"]
    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    jax_ckpt.save_checkpoint(whole, params)
    jax_ckpt.save_partial_checkpoint(part, params, ["decoder"])
    want = from_jax_params(jax.device_get(params))
    for i, (overrides, comps) in enumerate([
            ({"training.load_model": whole}, ("encoder", "decoder", "joint")),
            ({"training.load_encoder": whole, "training.load_decoder": part},
             ("encoder", "decoder"))]):
        port_cfg = Config(cfg.to_dict())
        for key, value in overrides.items():
            port_cfg.override(key, value)
        tr = Trainer(port_cfg, exp_root=str(tmp_path / f"egs{i}"), device="cpu")
        for name, p in tr.model.named_parameters():
            same = torch.equal(p.detach(), want[name])
            assert same == name.startswith(comps), name


# ---------------------------------------------------------------------------
# the optimizer state's layouts

def _names_and_tree(variables):
    names = list(from_jax_params(variables["params"]))
    return names, jax.device_get(variables["params"])


@pytest.mark.parametrize("kind,keys", [("sgd", {"trace"}), ("adam", {"mu", "nu"}),
                                       ("adadelta", {"e_g", "e_x"})])
@pytest.mark.parametrize("clip,accum", [(200, 1), (None, 1), (200, 2)])
def test_optimizer_state_maps_every_layout(variables, kind, keys, clip, accum):
    """sgd / adam / adadelta, with and without the clip, inside optax
    MultiSteps or not: the moments are the parameters' key map and
    transposes (a kernel's moment transposed like the kernel)."""
    import optax
    names, params = _names_and_tree(variables)
    tx = jax_optim.build_optimizer(Config({"type": kind, "lr": 0.05, "momentum": 0.9}),
                                   max_grad_norm=clip)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum).gradient_transformation()
    state = tx.init(params)
    grads = jax.tree_util.tree_map(lambda p: jnp.cos(p) * 0.1, params)
    for _ in range(accum + 1):
        _, state = tx.update(grads, state, params)
    tree = flax_ser.msgpack_restore(flax_ser.to_bytes(jax.device_get(state)))
    sd = optimizer_from_jax(tree, names)
    assert sd["kind"] == kind and set(sd["state"]) == keys | ({"acc"} if accum > 1 else set())
    assert sd["count"] == (1 if accum > 1 else 2) and sd["lr"] == pytest.approx(0.05)
    assert sd["mini_step"] == (1 if accum > 1 else 0)
    inner = tree["inner_opt_state"] if accum > 1 else tree
    inner = inner["1"] if clip else inner
    key = sorted(keys)[0]
    moment = from_jax_params(inner["inner_state"]["1"][key])
    for name, tensor in zip(names, sd["state"][key]):
        assert torch.equal(tensor, moment[name]), name
    qkv = "encoder.layers.0.MultiHeadAttention.dec_attn.qkv_net.weight"
    leaf = inner["inner_state"]["1"][key]["encoder"]["layer_0"]["attn"]["qkv"]["kernel"]
    assert torch.equal(sd["state"][key][names.index(qkv)], t(np.array(leaf).T))


def test_unknown_optimizer_layout_raises(variables):
    names, params = _names_and_tree(variables)
    odd = {"0": {}, "1": {"count": np.int32(1), "hyperparams": {"learning_rate": 0.1},
                          "inner_state": {"0": {}, "1": {"velocity": params}, "2": {}}}}
    with pytest.raises(ValueError, match="no counterpart"):
        optimizer_from_jax(odd, names)
    with pytest.raises(ValueError, match="not an optax state"):
        optimizer_from_jax({"a": {}, "b": {}}, names)
    short = {"0": {}, "1": {"count": np.int32(1), "hyperparams": {"learning_rate": 0.1},
                            "inner_state": {"0": {}, "1": {"trace": {
                                "encoder": params["encoder"], "decoder": params["decoder"],
                                "joint": {}}}, "2": {}}}}
    with pytest.raises(ValueError, match="not laid out like the parameters"):
        optimizer_from_jax(short, names)


def test_int8_baked_checkpoint_raises(tmp_path, variables):
    """The ``quant`` marker is honoured (int8-baked checkpoints load since
    port item 9, ``tests/test_torch_port_quant.py``): a float tree marked
    int8 loads into the quantised model and fails on its keys, and a
    marker other than int8 raises."""
    jax_ckpt.save_checkpoint(str(tmp_path), variables["params"])
    meta = json.load(open(tmp_path / "meta.json"))
    json.dump({**meta, "quant": "int8"}, open(tmp_path / "meta.json", "w"))
    assert ckpt_lib.load_checkpoint(str(tmp_path))["quant"] == "int8"
    with pytest.raises(RuntimeError, match="weight_q"):
        load_family(Config({"model": tiny_model_cfg()}), 64, str(tmp_path), device="cpu")
    json.dump({**meta, "quant": "int4"}, open(tmp_path / "meta.json", "w"))
    with pytest.raises(ValueError, match="int4"):
        ckpt_lib.load_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="int4"):
        load_family(Config({"model": tiny_model_cfg()}), 64, str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# the msgpack reader, type by type

@pytest.mark.parametrize("value", [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -2 ** 15, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 63,
    0.25, -1e300, "", "a" * 31, "b" * 32, "é" * 200, "c" * 70000, b"", b"\x00" * 255,
    b"\x01" * 256, b"\x02" * 70000, [], [1] * 15, [1] * 16, list(range(70000)),
    {}, {str(i): i for i in range(15)}, {str(i): -i for i in range(16)},
    {str(i): None for i in range(70000)}, {"a": [1, {"b": [b"x", -7]}]}],
    ids=lambda v: type(v).__name__ + str(len(v) if hasattr(v, "__len__") else v)[:12])
def test_reader_decodes_every_msgpack_form(value):
    assert flax_msgpack.unpackb(msgpack.packb(value, use_bin_type=True)) == value


def test_reader_decodes_single_floats_and_flax_ext_types():
    assert flax_msgpack.unpackb(msgpack.packb(0.5, use_single_float=True)) == 0.5
    tree = {"bf16": jnp.asarray([1.5, -2.0, 3.25], jnp.bfloat16),
            "scalar": np.float32(2.5), "count": np.asarray(7, np.int32),
            "complex": 1.5 - 2j, "big": np.arange(70000, dtype=np.int64),
            "b4": np.ones(1, np.float32), "b8": np.ones(2, np.float32), "b1": np.ones(1, np.bool_)}
    data = flax_ser.to_bytes(tree)
    got = flax_msgpack.msgpack_restore(data)
    assert got["bf16"].dtype == torch.bfloat16
    assert got["bf16"].float().tolist() == [1.5, -2.0, 3.25]
    assert type(got["scalar"]) is np.float32 and got["scalar"] == 2.5
    assert got["count"].shape == () and got["count"].dtype == np.int32
    assert got["complex"] == 1.5 - 2j
    assert np.array_equal(got["big"], np.arange(70000))
    _assert_same_tree(got, flax_ser.msgpack_restore(data))


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 3, 200, 300, 70000])
def test_unknown_ext_and_type_bytes_raise_with_offset(n):
    data = msgpack.packb({"k": msgpack.ExtType(9, b"z" * n)})
    with pytest.raises(ValueError, match=r"ext code 9 at offset 3"):
        flax_msgpack.unpackb(data)
    with pytest.raises(ValueError, match=r"type byte 0xc1 at offset 2"):
        flax_msgpack.unpackb(b"\x92\x01\xc1")
    with pytest.raises(ValueError, match="ends early"):
        flax_msgpack.unpackb(data[:-1])


def test_chunked_leaves_are_joined(monkeypatch):
    """flax splits leaves over MAX_CHUNK_SIZE bytes; shrink the limit so a
    small tree takes the chunked form, which the reader joins back."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(100, dtype=np.float32).reshape(4, 25), "s": np.ones(3, np.float32),
            "h": jnp.ones((40,), jnp.bfloat16)}
    data = flax_ser.msgpack_serialize(tree)
    raw = flax_msgpack.unpackb(data)
    assert raw["w"][flax_msgpack.CHUNKED] is True
    got = flax_msgpack.msgpack_restore(data)
    assert np.array_equal(got["w"], tree["w"]) and np.array_equal(got["s"], tree["s"])
    assert got["h"].shape == (40,) and bool((got["h"].float() == 1).all())
    bad = flax_msgpack.unpackb(data)
    del bad["w"]["chunks"]["1"]
    with pytest.raises(ValueError, match="chunked leaf '/w'"):
        flax_msgpack._restore(bad, "")


try:
    from hypothesis import given, settings, strategies as st
except ImportError:     # random trees only where hypothesis is installed
    st = None

if st is not None:
    _scalars = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
                | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=300))
    _trees = st.recursive(_scalars, lambda kids: st.lists(kids, max_size=20)
                          | st.dictionaries(st.text(max_size=8), kids, max_size=20), max_leaves=60)

    @settings(max_examples=150, deadline=None)
    @given(_trees)
    def test_reader_round_trips_random_trees(tree):
        assert flax_msgpack.unpackb(msgpack.packb(tree, use_bin_type=True)) == tree

    _arrays = st.sampled_from(["float32", "float64", "int32", "int64", "uint8", "int8",
                               "float16", "bool"]).flatmap(
        lambda dt: st.lists(st.integers(0, 3), min_size=0, max_size=3).map(
            lambda shape: (np.arange(int(np.prod(shape))) % 7).astype(dt).reshape(shape)))
    _state_dicts = st.recursive(
        _arrays | st.integers(-2 ** 63, 2 ** 64 - 1),
        lambda kids: st.dictionaries(st.text(min_size=1, max_size=6), kids, min_size=1,
                                     max_size=6), max_leaves=20).filter(
        lambda x: isinstance(x, dict))

    @settings(max_examples=100, deadline=None)
    @given(_state_dicts)
    def test_chip_smoke_writer_matches_flax_to_bytes(tree):
        """``chip_smoke.py``'s writer (the card has no flax) gives the bytes of
        ``flax.serialization.to_bytes`` for the same state dict, and the reader
        reads them back."""
        data = chip_smoke.msgpack_bytes(tree)
        assert data == flax_ser.to_bytes(tree)
        _assert_same_tree(flax_msgpack.msgpack_restore(data), flax_ser.msgpack_restore(data))


def test_chip_smoke_writer_bfloat16_and_optimizer_tree(tmp_path, variables):
    """A bfloat16 leaf written from a torch tensor gives flax's bytes for the
    JAX bfloat16 array; ``write_jax_checkpoint`` with ``sgd_state`` makes a
    directory the port continues from, its trace in the parameters' layout."""
    ones = jnp.ones((2, 3), jnp.bfloat16)
    assert (chip_smoke.msgpack_bytes({"x": torch.ones(2, 3, dtype=torch.bfloat16)})
            == flax_ser.to_bytes({"x": ones}))
    params = jax.device_get(variables["params"])
    opt = chip_smoke.sgd_state(params, 0.01, 4, 1e-3, seed=0)
    assert chip_smoke.msgpack_bytes(opt) == flax_ser.to_bytes(opt)
    path = chip_smoke.write_jax_checkpoint(str(tmp_path / "epoch_0"), params, opt,
                                           {"step": 4, "lr": 0.01})
    names = list(from_jax_params(params))
    state = ckpt_lib.load_checkpoint(path, param_names=names)
    assert state["optimizer"]["kind"] == "sgd" and state["optimizer"]["count"] == 4
    trace = from_jax_params(opt["1"]["inner_state"]["1"]["trace"])
    assert all(torch.equal(a, trace[n]) for n, a in
               zip(names, state["optimizer"]["state"]["trace"]))
    assert (state["epoch"], state["step"], state["lr"]) == (0, 4, 0.01)
