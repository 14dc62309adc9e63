"""PyTorch port: int8 serving, W8A8 with dynamic per-row activation scales
(``ops/quant.py``, ``models/factory.py::to_quant``, int8-baked checkpoints
and ``--int8`` in the CLIs), held against the JAX package's int8 path on
the same weights; mirrors ``tests/test_quant.py`` (native family).

The quantise steps and the int8 projection are bit-equal to the JAX
functions; tokens (greedy, beam, the sessions, the CLIs) identical; scores
and confidences within ``TOL`` (rtol 2e-4, atol 2e-5).
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.decoding import beam as jax_beam
from transformer_transducer_tpu.decoding.greedy import greedy_decode as jax_greedy_decode
from transformer_transducer_tpu.ops import quant as jax_quant
from transformer_transducer_tpu.ops.masks import context_mask as jax_context_mask
from transformer_transducer_tpu.streaming import batched as jax_batched
from transformer_transducer_tpu.streaming import session as jax_session
from transformer_transducer_tpu_torch.apps import predict as predict_app
from transformer_transducer_tpu_torch.apps import stream_demo
from transformer_transducer_tpu_torch.data.wav import write_wave
from transformer_transducer_tpu_torch.decoding import beam
from transformer_transducer_tpu_torch.decoding.greedy import greedy_decode
from transformer_transducer_tpu_torch.models.factory import load_family, to_quant
from transformer_transducer_tpu_torch.ops import quant
from transformer_transducer_tpu_torch.streaming.batched import BatchedStreamingSession
from transformer_transducer_tpu_torch.streaming.session import StreamingSession
from transformer_transducer_tpu_torch.tools import quantize_checkpoint
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.convert import COMPONENTS, from_jax_params

from test_torch_port_streaming import (
    assert_same_stream, emitting_models, feed, jax_scfg, scfg, wave)
from torch_port_helpers import TOL, t

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    """(JAX int8 model, its int8 variables, the port's int8 model, the
    float JAX model, float variables, float port model), one set of
    weights with the blank logit biased so that some frames emit."""
    jm, variables, pm = emitting_models(seed=3, share=0.3)
    return (jm.clone(quant=True), jax_quant.quantize_variables(variables), to_quant(pm),
            jm, variables, pm)


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# ops/quant.py against the JAX functions

# the JAX functions as XLA compiles them in every serving program: the
# division by the constant 127 becomes a product with its float32
# reciprocal (an op-by-op call divides, and its scales may differ by an
# ulp; see ops/quant.py::INV_INT8_MAX)
JIT_QUANTIZE_WEIGHT = jax.jit(jax_quant.quantize_weight)
JIT_QUANTIZE_ACTIVATION = jax.jit(jax_quant.quantize_activation)
JIT_QUANT_DENSE_APPLY = jax.jit(jax_quant.quant_dense_apply)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_weight_and_activation_are_bit_equal_to_jax(seed):
    w = _rng(seed).standard_normal((96, 40)).astype(np.float32)       # (in, out)
    w[:, 3] = 0.0                                                     # an all-zero channel
    ref = JIT_QUANTIZE_WEIGHT(jnp.asarray(w))
    w_q, scale = quant.quantize_weight(t(w.T.copy()))
    assert w_q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(w_q.numpy().T, np.asarray(ref["kernel_q"]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref["scale"]))
    # ties at .5 of a step round half to even in both
    x = (_rng(seed + 10).standard_normal((7, 3, 64)) * 3).astype(np.float32)
    x[0, 0, :4] = [127.0, 0.5, 1.5, -2.5]
    x_q, s_a = quant.quantize_activation(t(x))
    rx_q, rs_a = JIT_QUANTIZE_ACTIVATION(jnp.asarray(x))
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(rx_q))
    np.testing.assert_array_equal(s_a.numpy(), np.asarray(rs_a))
    assert x_q[0, 0, :4].tolist() == [127, 0, 2, -2]
    # the op-by-op JAX call's scales: within an ulp
    eager = np.asarray(jax_quant.quantize_weight(jnp.asarray(w))["scale"])
    np.testing.assert_array_max_ulp(scale.numpy(), eager, maxulp=1)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(1, 64, 12), (5, 128, 96), (17, 96, 40), (40, 64, 6485)])
def test_quant_dense_apply_is_bit_equal_to_jax(m, k, n, bias):
    rng = _rng(m * k + n)
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32) if bias else None
    ref = JIT_QUANTIZE_WEIGHT(jnp.asarray(w))
    want = JIT_QUANT_DENSE_APPLY(jnp.asarray(x), ref["kernel_q"], ref["scale"],
                                 None if b is None else jnp.asarray(b))
    w_q, scale = quant.quantize_weight(t(w.T.copy()))
    got = quant.quant_dense_apply(t(x), w_q, scale, None if b is None else t(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    layer = torch.nn.Linear(k, n, bias=bias)
    with torch.no_grad():
        layer.weight.copy_(t(w.T.copy()))
        if bias:
            layer.bias.copy_(t(b))
    qlayer = quant.QuantLinear.from_linear(layer)
    assert (qlayer.in_features, qlayer.out_features) == (k, n)
    assert torch.equal(qlayer(t(x)), got)
    np.testing.assert_array_equal(quant.dense_kernel(qlayer).numpy(),
                                  np.asarray(jax_quant.dense_kernel(ref)).T)


@pytest.mark.parametrize("m", [1, 5, 16, 17, 40])
@pytest.mark.parametrize("k", [512, 2048])
def test_int_mm_padding_is_exact(m, k):
    """The operands padded for ``torch._int_mm``'s CUDA shape rules (more
    than 16 rows, K and N multiples of 8) give the exact product in their
    (M, N) corner, at V = 6485 (the float64 product of int8 values is
    exact: |sum| < 2^53)."""
    rng = _rng(m + k)
    x_q = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (6485, k), dtype=np.int8))
    a, b = quant.int_mm_operands(x_q, w_q)
    assert a.shape[0] > 16 and a.shape[0] % 8 == 0 and a.shape[1] % 8 == 0
    assert b.shape[0] % 8 == 0 and b.shape[1] == a.shape[1]
    want = x_q.double() @ w_q.double().t()
    padded = a.to(torch.int32) @ b.to(torch.int32).t()
    assert torch.equal(padded[:m, :6485].double(), want)
    assert not padded[m:].any() and not padded[:, 6485:].any()
    assert torch.equal(quant.int8_matmul(x_q, w_q).double(), want)
    w_mm = quant.int_mm_weight(w_q)
    assert torch.equal(quant.int_mm_operands(x_q, w_q, w_mm)[0], a)
    assert torch.equal(w_mm, b)


def test_quant_linear_keeps_its_padded_weight_until_the_weight_changes():
    """``QuantLinear.mm_weight`` pads the weight once; a ``load_state_dict``
    (an in-place write) or a new ``weight_q`` makes it again.  A weight
    whose shapes are multiples of 8 is taken as it is."""
    layer = quant.QuantLinear.from_linear(torch.nn.Linear(16, 13))
    padded = layer.mm_weight()
    assert padded.shape == (16, 16) and layer.mm_weight() is padded
    assert torch.equal(padded[:13], layer.weight_q) and not padded[13:].any()
    other = quant.QuantLinear.from_linear(torch.nn.Linear(16, 13))
    layer.load_state_dict(other.state_dict())
    assert set(layer.state_dict()) == {"weight_q", "scale", "bias"}
    assert torch.equal(layer.mm_weight()[:13], other.weight_q)
    layer.weight_q = other.weight_q.clone() * 0
    assert not layer.mm_weight().any()
    square = quant.QuantLinear.from_linear(torch.nn.Linear(16, 24))
    assert square.mm_weight() is square.weight_q


# ---------------------------------------------------------------------------
# the quantised model and its keys

def _to_jax_tree(sd):
    """The inverse of ``utils/convert.py::from_jax_params`` for a quantised
    model's ``state_dict``: the JAX int8 tree (``quantize_params``)."""
    def n(x):
        return x.numpy()

    def dense(prefix):
        p = {"kernel_q": n(sd[prefix + ".weight_q"]).T, "scale": n(sd[prefix + ".scale"])}
        if prefix + ".bias" in sd:
            p["bias"] = n(sd[prefix + ".bias"])
        return p

    def stack(comp):
        layers = {}
        i = 0
        while f"{comp}.layers.{i}.r_emb" in sd:
            p, m = f"{comp}.layers.{i}.", f"{comp}.layers.{i}.MultiHeadAttention."
            layers[f"layer_{i}"] = {
                "r_emb": n(sd[p + "r_emb"]), "r_w_bias": n(sd[p + "r_w_bias"]),
                "r_bias": n(sd[p + "r_bias"]),
                "attn": {"qkv": dense(m + "dec_attn.qkv_net"), "out": dense(m + "dec_attn.o_net"),
                         "ln": {"scale": n(sd[m + "dec_attn.layer_norm.weight"]),
                                "bias": n(sd[m + "dec_attn.layer_norm.bias"])}},
                "ff": {"ln": {"scale": n(sd[m + "pos_ff.layer_norm.weight"]),
                              "bias": n(sd[m + "pos_ff.layer_norm.bias"])},
                       "fc1": dense(m + "pos_ff.CoreNet.0"), "fc2": dense(m + "pos_ff.CoreNet.3")}}
            i += 1
        return layers

    decoder = stack("decoder")
    decoder["embedding"] = {"embedding": n(sd["decoder.dec_embedding.weight"])}
    return {"encoder": stack("encoder"), "decoder": decoder,
            "joint": {"forward_layer": dense("joint.forward_layer"),
                      "project_layer": dense("joint.project_layer")}}


def test_quantised_keys_round_trip_through_the_jax_int8_tree(models):
    jmq, vq, pmq, _, _, pm = models
    assert pmq.quant and not pm.quant and isinstance(pm.joint.forward_layer, torch.nn.Linear)
    n_quant = sum(isinstance(m, quant.QuantLinear) for m in pmq.modules())
    assert n_quant == 2 + 4 * (len(pmq.encoder.layers) + len(pmq.decoder.layers))
    assert not any(isinstance(m, torch.nn.Linear) for m in pmq.modules())
    # the JAX int8 tree maps onto the port's quantised model, to the bit of
    # the port's own quantisation
    sd = from_jax_params(vq["params"])
    own = pmq.state_dict()
    assert set(sd) == set(own)
    for key, value in own.items():
        assert value.dtype == sd[key].dtype and torch.equal(value, sd[key]), key
    back = _to_jax_tree(own)
    ref = jax.tree_util.tree_map(np.asarray, vq["params"])
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_split_joint_differs_under_int8_and_the_frame_decoders_do_not(models):
    """W8A8 takes one activation scale a row of the concatenation, so
    ``forward_layer(cat(e, d))`` is not the sum of the halves quantised
    apart; the frame decoders' ``first_layer`` takes the concatenation."""
    _, _, pmq, _, _, pm = models
    rng = _rng(4)
    e = t((rng.standard_normal((9, 64)) * 2).astype(np.float32))
    d = t(rng.standard_normal((1, 64)).astype(np.float32))
    fl = pmq.joint.forward_layer
    whole = fl(torch.cat([e, d.expand(9, -1)], -1))
    halves = (quant.quant_dense_apply(e, fl.weight_q[:, :64], fl.scale, fl.bias)
              + quant.quant_dense_apply(d, fl.weight_q[:, 64:], fl.scale))
    assert (halves - whole).abs().max() > 1e-3
    joint = pmq.joint
    assert torch.equal(joint.first_layer(joint.project_enc(e), joint.project_dec(d)), whole)
    assert torch.equal(pmq.joint_logits_from(joint.first_layer(e, d)),
                       pmq.joint_logits(e, d.expand(9, -1)))
    # a float joint's halves still add up to the whole, to rounding
    fj = pm.joint
    np.testing.assert_allclose(
        fj.first_layer(fj.project_enc(e), fj.project_dec(d)).detach().numpy(),
        fj.forward_layer(torch.cat([e, d.expand(9, -1)], -1)).detach().numpy(), **TOL)


# ---------------------------------------------------------------------------
# int8 decoding against JAX's int8 decoding

def _jax_encode(jmq, vq, x, mask=None):
    """The JAX int8 encoder as its serving paths run it: compiled (XLA's
    reciprocal scales and fused bias; an op-by-op call rounds otherwise,
    and W8A8 turns an ulp into a changed int8 step)."""
    return jax.jit(lambda v, xx, m: jmq.apply(v, xx, m, method="encode"))(
        vq, jnp.asarray(x), mask)


def _batch(seed, b=3, tmax=45):
    x = (_rng(seed).standard_normal((b, tmax, 64))).astype(np.float32)
    return x, np.array([tmax, tmax - 11, tmax - 20])


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("mode", ["band", "full_context"])
def test_int8_greedy_matches_jax(models, mode, use_cache):
    jmq, vq, pmq, _, _, _ = models
    x, t_len = _batch(1)
    mask = jax_context_mask(x.shape[1], 10, 2) if mode == "band" else None
    ref_enc = _jax_encode(jmq, vq, x, mask)
    rt, rc = jax_greedy_decode(jmq, vq, ref_enc, jnp.asarray(t_len), max_tokens=43,
                               use_cache=use_cache)
    with torch.no_grad():
        enc = pmq.encode_banded(t(x), 10, 2) if mode == "band" else pmq.encode(t(x))
    gt, gc = greedy_decode(pmq, enc, t_len, max_tokens=43, use_cache=use_cache)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    assert (gc > 1).all() and (gc - 1 < t(t_len)).all(), "some frames emit, some do not"
    # the einsums sum in another order in the two packages, and W8A8 turns
    # an ulp in a projection's input into a changed int8 step (about 0.01-
    # 0.02 after the LayerNorm), so the states are held at 5e-2, the tokens
    # exactly
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc), rtol=0, atol=5e-2)


@pytest.mark.parametrize("use_cache", [True, False])
def test_int8_beam_matches_jax(models, use_cache):
    """The beam's split joint takes the dequantised weights (JAX
    ``dense_kernel``); its label encoder and the encoder run W8A8."""
    jmq, vq, pmq, _, _, _ = models
    x, t_len = _batch(2)
    ref_enc = _jax_encode(jmq, vq, x)
    rb, rc, rp = jax_beam.beam_search_batched(jmq, vq, ref_enc, jnp.asarray(t_len), 5, 43,
                                              0, use_cache)
    with torch.no_grad():
        enc = pmq.encode(t(x))
    gb, gc, gp = beam.beam_search_batched(pmq, enc, t_len, 5, 43, use_cache=use_cache)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(gp.numpy(), np.asarray(rp), **TOL)
    assert (gc[:, 0] > 1).all()


# ---------------------------------------------------------------------------
# the int8 sessions against JAX's int8 sessions (tests/test_quant.py:192,217)

@pytest.mark.parametrize("incremental", [False, True])
def test_int8_session_matches_jax(models, incremental):
    jmq, vq, pmq, _, _, _ = models
    wav = wave(30000, gate=12000)
    got = feed(StreamingSession(pmq, scfg(blank_split=4), device="cpu",
                                incremental=incremental), wav, 4000)
    ref = feed(jax_session.StreamingSession(jmq, vq, jax_scfg(blank_split=4),
                                            incremental=incremental), wav, 4000)
    assert_same_stream(got, ref)
    if incremental:         # int8 x incremental: the int8 window path's stream
        window = feed(StreamingSession(pmq, scfg(blank_split=4), device="cpu"), wav, 4000)
        assert got.result == window.result and got.timestamps == window.timestamps


@pytest.mark.parametrize("incremental", [False, True])
def test_int8_batched_session_matches_jax(models, incremental):
    jmq, vq, pmq, _, _, _ = models
    wavs = [wave(n, seed=s, freq=0.02 + 0.005 * s, gate=9000)
            for s, n in enumerate([24000, 33000])]
    split = dict(window_len=64, blank_split=4)

    def fed(session):
        for i, w in enumerate(wavs):
            session.accept_waveform(i, w)
            session.finalize(i)
        session.run_to_completion()
        return session

    got = fed(BatchedStreamingSession(pmq, scfg(**split), 2, incremental=incremental,
                                      device="cpu"))
    ref = fed(jax_batched.BatchedStreamingSession(jmq, vq, jax_scfg(**split), n_streams=2,
                                                  incremental=incremental))
    assert any(st.result for st in ref.streams)
    for g, r in zip(got.streams, ref.streams):
        assert g.result == r.result and g.timestamps == r.timestamps
        np.testing.assert_allclose(g.confidences, r.confidences, **TOL)


# ---------------------------------------------------------------------------
# int8-baked checkpoints and the CLIs

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny config and vocabulary, a float JAX checkpoint and the JAX
    package's int8-baked copy of it (the root ``tools/quantize_checkpoint.py``)."""
    from transformer_transducer_tpu.models.factory import build_family
    from transformer_transducer_tpu.utils import checkpoint as jax_ckpt
    from transformer_transducer_tpu.utils.config import dump_config

    from data_helpers import tiny_train_config
    tmp = tmp_path_factory.mktemp("quant")
    vocab = tmp / "vocab.txt"
    vocab.write_text("<b> 0\n" + "".join(f"w{i} {i}\n" for i in range(1, 12)))
    cfg = tiny_train_config(str(tmp), str(vocab), {"train": "x", "dev": "x", "test": "x"})
    dump_config(cfg, str(tmp / "cfg.yaml"))
    _, variables, _ = build_family(cfg, 16)
    float_dir = jax_ckpt.save_checkpoint(str(tmp / "float"), variables["params"], epoch=3,
                                         step=77)
    _root_module("tools", "quantize_checkpoint").main([float_dir, str(tmp / "int8")])
    return {"dir": tmp, "cfg": str(tmp / "cfg.yaml"), "float": float_dir,
            "int8": str(tmp / "int8"), "variables": variables}


def _root_module(folder, name):
    spec = importlib.util.spec_from_file_location(f"ttx_root_{folder}_{name}",
                                                  os.path.join(ROOT, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_cfg(served):
    from transformer_transducer_tpu_torch.utils.config import load_config
    return load_config(served["cfg"])


def _same_tensors(a, b):
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key


def test_jax_int8_baked_directory_loads_as_the_jax_tree(served):
    from flax import serialization
    with open(os.path.join(served["int8"], "meta.json")) as fh:
        assert json.load(fh)["quant"] == "int8"
    cfg = _port_cfg(served)
    model = load_family(cfg, 16, served["int8"], device="cpu")
    assert model.quant
    tree = {}
    for comp in COMPONENTS:
        with open(os.path.join(served["int8"], f"{comp}.msgpack"), "rb") as fh:
            tree[comp] = serialization.msgpack_restore(fh.read())
    _same_tensors(model.state_dict(), from_jax_params(tree))
    # the same as quantising the float checkpoint in memory, and as --int8
    # on the float checkpoint
    ref = to_quant(load_family(cfg, 16, served["float"], device="cpu"))
    _same_tensors(model.state_dict(), ref.state_dict())
    _same_tensors(load_family(cfg, 16, served["float"], device="cpu", int8=True).state_dict(),
                  ref.state_dict())


@pytest.mark.parametrize("source", ["jax", "port_dir", "flat"])
def test_port_quantize_tool_round_trips_and_shrinks(served, tmp_path, capsys, source):
    cfg = _port_cfg(served)
    float_model = load_family(cfg, 16, served["float"], device="cpu")
    if source == "jax":
        src = served["float"]
    elif source == "port_dir":
        src = ckpt_lib.save_checkpoint(str(tmp_path / "epoch_3"), float_model, epoch=3, step=77)
    else:
        src = str(tmp_path / "flat.pt")
        torch.save(float_model.state_dict(), src)
    sizes = quantize_checkpoint.main([src, str(tmp_path / "int8"), "--device", "cpu"])
    assert "MiB" in capsys.readouterr().out
    with open(tmp_path / "int8" / "meta.json") as fh:
        meta = json.load(fh)
    assert meta["quant"] == "int8" and meta["step"] == (0 if source == "flat" else 77)
    loaded = load_family(cfg, 16, str(tmp_path / "int8"), device="cpu")
    assert loaded.quant
    _same_tensors(loaded.state_dict(), to_quant(float_model).state_dict())
    # int8 projections: under 0.6 of the weights' bytes (about a quarter
    # where the projections dominate; this toy model is mostly position
    # tables, embeddings and LayerNorms), and a smaller file
    assert sizes["weights_out"] < 0.6 * sizes["weights_in"]
    assert sizes["file_out"] < sizes["file_in"]
    with pytest.raises(ValueError, match="int8-baked already"):
        quantize_checkpoint.main([str(tmp_path / "int8"), str(tmp_path / "again"),
                                  "--device", "cpu"])


def _wav(directory, n=24000):
    rng = np.random.RandomState(0)
    path = str(directory / f"a{n}.wav")
    write_wave(path, np.sin(np.arange(n) * 0.02) * 9000 + rng.randn(n) * 1500)
    return path


@pytest.mark.parametrize("flags", [[], ["--full-context"], ["--beam"]])
@pytest.mark.parametrize("ckpt", ["float", "int8"])
def test_predict_int8_cli_matches_the_jax_cli(served, monkeypatch, capsys, flags, ckpt):
    """``apps/predict.py --int8`` (the float checkpoint quantised after
    loading, or the int8-baked one) against the root JAX CLI's."""
    argv = ["--config", served["cfg"], "--checkpoint", served[ckpt],
            "--wav", _wav(served["dir"]), "--int8", *flags]
    text = predict_app.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["predict.py", *argv])
    _root_module("apps", "predict").main()
    assert text and f"prediction: {text}\n" in capsys.readouterr().out


@pytest.mark.parametrize("incremental", [False, True])
def test_stream_demo_int8_cli_matches_the_jax_cli(served, monkeypatch, capsys, incremental):
    argv = ["--config", served["cfg"], "--checkpoint", served["int8"],
            "--wav", _wav(served["dir"], 30000), "--int8", "--chunk-ms", "250"] + (
                ["--incremental"] if incremental else [])
    text = stream_demo.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["stream_demo.py", *argv])
    _root_module("apps", "stream_demo").main()
    assert text and f"final: {text}\n" in capsys.readouterr().out
