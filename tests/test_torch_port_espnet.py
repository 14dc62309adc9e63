"""PyTorch port: the espnet model family (``models/espnet_variant.py``), its
label cache, greedy and beam decoding, int8 serving and the weights'
mapping, held against the JAX package's espnet functions on the same
weights and inputs (its checkpoints and the predict CLI:
``tests/test_torch_port_espnet_checkpoint.py``); mirrors ``tests/test_espnet_label_cache.py``,
the espnet cases of ``tests/test_quant.py`` and the parts of
``tests/test_espnet_variant.py`` that need no upstream model.

Encoder, text-encoder and joint states within ``TOL`` (rtol 2e-4, atol
2e-5); tokens and beam counts identical, beam scores within ``TOL``; int8
weights bit-equal to the JAX quantisation as XLA compiles it.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.decoding import beam as jax_beam
from transformer_transducer_tpu.decoding import espnet_label_cache as jax_elc
from transformer_transducer_tpu.decoding.greedy import greedy_decode as jax_greedy_decode
from transformer_transducer_tpu.models import espnet_variant as jax_ev
from transformer_transducer_tpu.ops import quant as jax_quant
from transformer_transducer_tpu.utils.torch_convert import espnet_transducer_params
from transformer_transducer_tpu_torch.decoding import beam
from transformer_transducer_tpu_torch.decoding import espnet_label_cache as elc
from transformer_transducer_tpu_torch.decoding.greedy import (
    decode_reference_exact, greedy_decode, recognize)
from transformer_transducer_tpu_torch.models import espnet_variant as ev
from transformer_transducer_tpu_torch.models.factory import to_quant
from transformer_transducer_tpu_torch.ops import quant
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.convert import from_jax_params, random_jax_params

from torch_port_helpers import (
    TOL, bias_espnet_blank, jax_espnet_model, port_espnet_model, t, tiny_espnet_cfg)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 24
D = 32
T_LEN = np.array([41, 30, 17])
INPUT_LAYERS = [None, "embed", "linear", "conv2d", "conv2d6", "conv2d8"]


def _rng(seed):
    return np.random.default_rng(seed)


def _inputs(cfg, seed=0, t_len=T_LEN):
    """A padded batch for the encoder (feature rows, or token ids for the
    ``embed`` input layer) and a padded text batch."""
    rng = _rng(seed)
    enc = cfg["enc"]
    if enc["input_layer"] == "embed":
        x = rng.integers(0, enc["input_size"], (len(t_len), t_len.max()))
    else:
        x = rng.standard_normal((len(t_len), t_len.max(), enc["input_size"])).astype(np.float32)
    y = rng.integers(1, V - 1, (len(t_len), 7))
    return x, y, np.array([7, 4, 1])


def _emitting(cfg, variables, enc, share=0.35):
    """Bias the blank logit so that about ``share`` of the frames emit at
    the sos label state."""
    pm = port_espnet_model(cfg, variables)
    with torch.no_grad():
        dec = pm.predict(torch.full((enc.shape[0], 1), V - 1))
        logits = pm.joint_logits(t(enc), dec)[:, :, 0]
    margin = logits[..., 1:].max(-1).values - logits[..., 0]
    return bias_espnet_blank(variables, float(np.quantile(margin.numpy(), 1 - share)))


@functools.lru_cache(maxsize=None)
def _layer_model(input_layer):
    """(cfg, JAX model, variables) of an input layer's test model, built
    once for the module (read only)."""
    cfg = tiny_espnet_cfg(input_layer, vocab=V, d=D, d_in=20 if input_layer else None)
    if input_layer == "embed":
        cfg["enc"]["input_size"] = 30
    return (cfg, *jax_espnet_model(cfg))


@pytest.fixture(scope="module")
def emitting():
    """(cfg, JAX model, variables, port model, feature batch, encoder rows):
    the blank biased so that some frames emit."""
    cfg = tiny_espnet_cfg(vocab=V, d=D)
    jm, variables = jax_espnet_model(cfg, seed=1)
    x = _rng(5).standard_normal((3, T_LEN.max(), D)).astype(np.float32)
    with torch.no_grad():
        enc0 = port_espnet_model(cfg, variables).encode(t(x), t(T_LEN)).numpy()
    variables = _emitting(cfg, variables, enc0)
    pm = port_espnet_model(cfg, variables)
    with torch.no_grad():
        enc = pm.encode(t(x), t(T_LEN)).numpy()
    return cfg, jm, variables, pm, x, enc


# ---------------------------------------------------------------------------
# the model against the JAX module

@pytest.mark.parametrize("length", [1, 2, 17, 410])
def test_signed_rel_shift_and_encodings_match_jax(length):
    x = _rng(length).standard_normal((2, 3, length, 2 * length - 1)).astype(np.float32)
    got = ev.rel_shift_signed(t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ev._rel_shift_signed(jnp.asarray(x))))
    i, j = np.meshgrid(np.arange(length), np.arange(length), indexing="ij")
    np.testing.assert_array_equal(got, x[..., i, length - 1 + j - i])
    np.testing.assert_array_equal(ev.rel_positional_encoding(length, 16),
                                  jax_ev.rel_positional_encoding(length, 16))


@pytest.mark.parametrize("input_layer", INPUT_LAYERS)
def test_model_matches_jax(input_layer):
    """``encode``, ``encode_both``, ``predict`` and ``joint_logits`` on a
    padded batch; ``encoded_lengths`` of the conv input layers."""
    cfg, jm, variables = _layer_model(input_layer)
    pm = port_espnet_model(cfg, variables)
    x, y, y_len = _inputs(cfg)
    jx = jnp.asarray(x)
    buf = np.concatenate([np.full((3, 1), V - 1), y], 1)

    @jax.jit
    def ref_fn(v):
        enc, dec = jm.apply(v, jx, jnp.asarray(T_LEN), jnp.asarray(y), jnp.asarray(y_len),
                            method="encode_both")
        return (enc, dec, jm.apply(v, enc, dec, method="joint_logits"),
                jm.apply(v, jx, None, method="encode"),
                jm.apply(v, jnp.asarray(buf), method="predict"))

    ref_enc, ref_dec, ref_logits, ref_unpadded, ref_predict = ref_fn(variables)
    with torch.no_grad():
        enc, dec = pm.encode_both(t(x), t(T_LEN), t(y), t(y_len))
        np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc), **TOL)
        np.testing.assert_allclose(dec.numpy(), np.asarray(ref_dec), **TOL)
        np.testing.assert_allclose(pm.joint_logits(enc, dec).numpy(), np.asarray(ref_logits),
                                   **TOL)
        np.testing.assert_allclose(pm.encode(t(x)).numpy(), np.asarray(ref_unpadded), **TOL)
        np.testing.assert_allclose(pm.predict(t(buf)).numpy(), np.asarray(ref_predict), **TOL)
    np.testing.assert_array_equal(pm.encoded_lengths(t(T_LEN), x.shape[1]).numpy(),
                                  np.asarray(jm.encoded_lengths(jnp.asarray(T_LEN), x.shape[1])))
    assert enc.shape[1] == ref_enc.shape[1]


def test_sos_embeds_to_zero_and_padded_rows_attend_to_nothing():
    """The sos = V - 1 row is espnet's padding_idx: it embeds to zero.  A
    query with every key masked attends to nothing (zeros, not NaN)."""
    cfg, _, variables = _layer_model(None)
    pm = port_espnet_model(cfg, variables)
    dec = pm.decoder
    x, _ = dec.input_transform(torch.tensor([[V - 1, 3]]))
    assert dec.pad_row == V - 1 and (x[0, 0] == 0).all() and (x[0, 1] != 0).any()
    attn = pm.encoder.encoders[0].self_attn
    h = torch.randn(2, 5, D)
    mask = torch.zeros(2, 5, 5, dtype=torch.bool)
    mask[1] = True
    with torch.no_grad():
        out = attn(h, ev._pos_table(5, D, torch.device("cpu")), mask)
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(out[1].numpy(), attn.linear_out.bias.detach().expand(5, D).numpy())


@pytest.mark.parametrize("input_layer", INPUT_LAYERS)
def test_state_dict_maps_back_to_the_jax_tree(input_layer):
    """The port's keys are upstream espnet's: the JAX package's
    ``espnet_transducer_params`` reads the port's state dicts as the JAX
    tree, leaf for leaf; ``random_jax_params`` seeds the same layout."""
    cfg, _, variables = _layer_model(input_layer)
    pm = port_espnet_model(cfg, variables)
    np_sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    back = espnet_transducer_params(np_sd(pm.encoder), np_sd(pm.decoder), np_sd(pm.joint))
    ref = variables["params"]
    assert jax.tree_util.tree_structure(back["params"]) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(back["params"]), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    rand = random_jax_params(Config(cfg), seed=0)
    assert jax.tree_util.tree_structure(rand) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(rand), jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    pm.load_state_dict(from_jax_params(rand))


# ---------------------------------------------------------------------------
# the label cache (tests/test_espnet_label_cache.py)

@pytest.mark.parametrize("n_layers,left", [(1, 2), (2, 2), (2, 4)])
def test_incremental_equals_full_recompute(n_layers, left):
    cfg = tiny_espnet_cfg(vocab=V, d=D, dec_blocks=n_layers, band=(3, 1, left))
    jm, variables = jax_espnet_model(cfg)
    pm = port_espnet_model(cfg, variables)
    b, cap = 3, 9
    seq = _rng(1).integers(0, V, (b, cap))
    seq[:, 0] = V - 1
    cache = elc.init_cache(pm.decoder, b, cap)
    jcache = jax_elc.init_cache(variables["params"], b, cap)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    with torch.no_grad():
        for u in range(cap):
            out, cache = elc.step(pm.decoder, t(seq[:, u]), cache,
                                  torch.ones(b, dtype=torch.bool), left=left)
            full = pm.predict(t(seq[:, :u + 1]))
            np.testing.assert_allclose(out.numpy(), full[:, -1].numpy(), **TOL)
            ref, jcache = jax_elc.step(variables["params"], jnp.asarray(seq[:, u]), jcache,
                                       jnp.ones((b,), bool), left=left)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), err_msg=f"position {u}",
                                       **TOL)


def test_masked_rows_do_not_advance():
    cfg = tiny_espnet_cfg(vocab=V, d=D, dec_blocks=1)
    pm = port_espnet_model(cfg, jax_espnet_model(cfg)[1])
    sos = pm.sos
    cache = elc.init_cache(pm.decoder, 2, 6)
    with torch.no_grad():
        _, cache = elc.step(pm.decoder, torch.tensor([sos, sos]), cache,
                            torch.tensor([True, True]))
        _, cache = elc.step(pm.decoder, torch.tensor([3, 7]), cache, torch.tensor([True, False]))
        assert cache["idx"].tolist() == [2, 1]
        out3, cache = elc.step(pm.decoder, torch.tensor([5, 7]), cache,
                               torch.tensor([False, True]))
        full = pm.predict(torch.tensor([[sos, 7]]))
    np.testing.assert_allclose(out3[1].numpy(), full[0, -1].numpy(), **TOL)


# ---------------------------------------------------------------------------
# greedy decoding

@pytest.mark.parametrize("use_cache", [True, False])
def test_greedy_matches_jax(emitting, use_cache):
    cfg, jm, variables, pm, _, enc = emitting
    rt, rc = jax_greedy_decode(jm, variables, jnp.asarray(enc), jnp.asarray(T_LEN),
                               max_tokens=20, use_cache=use_cache, seed_token=V - 1)
    gt, gc = greedy_decode(pm, t(enc), T_LEN, max_tokens=20, use_cache=use_cache)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    assert (gt[:, 0] == V - 1).all() and (gc > 3).all() and (gc - 1 < t(T_LEN)).all()


@pytest.mark.parametrize("input_layer", [None, "conv2d"])
def test_recognize_encodes_with_lengths_and_decodes_encoded_lengths(input_layer):
    """``recognize`` on a padded batch: the lengths are the pad mask, a conv
    input layer's ``encoded_lengths`` the frames decoded (the JAX CLI's
    espnet path); a band or an audio mask raises."""
    cfg = tiny_espnet_cfg(input_layer, vocab=V, d=D)
    jm, variables = jax_espnet_model(cfg, seed=2)
    x = _rng(3).standard_normal((3, T_LEN.max(), D)).astype(np.float32)
    pm = port_espnet_model(cfg, variables)
    with torch.no_grad():
        variables = _emitting(cfg, variables, pm.encode(t(x), t(T_LEN)).numpy(), share=0.5)
    pm = port_espnet_model(cfg, variables)
    got = recognize(pm, t(x), T_LEN, max_tokens=20)
    enc = jm.apply(variables, jnp.asarray(x), jnp.asarray(T_LEN), method="encode")
    t_enc = jm.encoded_lengths(jnp.asarray(T_LEN), x.shape[1])
    rt, rc = jax_greedy_decode(jm, variables, enc, t_enc, max_tokens=20, seed_token=V - 1)
    ref = [list(map(int, np.asarray(rt)[i, 1:int(rc[i])])) for i in range(3)]
    assert got == ref and any(got)
    with pytest.raises(ValueError, match="bands itself"):
        recognize(pm, t(x), T_LEN, band=(3, 2))


def test_reference_exact_decode_matches_jax(emitting):
    """The unmasked oracle re-encodes the whole history from sos (the JAX
    oracle with the espnet model's sos seed)."""
    cfg, jm, variables, pm, _, enc = emitting
    i = 2                                   # the 17-frame utterance
    got = decode_reference_exact(pm, t(enc[i]), int(T_LEN[i]))
    tokens = [V - 1]
    dec = jm.apply(variables, jnp.asarray([tokens]), method="predict")[0, -1]
    ref = []
    for f in range(int(T_LEN[i])):
        pred = int(jnp.argmax(jm.apply(variables, jnp.asarray(enc[i, f]), dec,
                                       method="joint_logits")))
        if pred != 0:
            tokens.append(pred)
            ref.append(pred)
            dec = jm.apply(variables, jnp.asarray([tokens]), method="predict")[0, -1]
    assert got == ref and got


# ---------------------------------------------------------------------------
# the beam search

@pytest.mark.parametrize("activation", ["tanh", "relu"])
@pytest.mark.parametrize("use_cache", [True, False])
def test_beam_matches_jax(emitting, use_cache, activation):
    cfg, jm, variables, pm, _, enc = emitting
    if activation == "relu":
        cfg = {**cfg, "joint": {**cfg["joint"], "joint_activation_type": "relu"}}
        jm, pm = _jax_build(cfg), port_espnet_model(cfg, variables)
        assert pm.joint_activation == "relu"
    rb, rc, rp = jax_beam.beam_search_batched(jm, variables, jnp.asarray(enc),
                                              jnp.asarray(T_LEN), 5, 20, 0, use_cache)
    gb, gc, gp = beam.beam_search_batched(pm, t(enc), T_LEN, 5, 20, use_cache=use_cache)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(gp.numpy(), np.asarray(rp), **TOL)
    assert (gb[:, :, 0] == V - 1).all() and (gc[:, 0] > 2).all()


def _jax_build(cfg):
    from transformer_transducer_tpu.utils.config import Config as JaxConfig
    return jax_ev.build_espnet_transducer(JaxConfig(cfg))


def test_recognize_beam_matches_jax(emitting):
    from transformer_transducer_tpu_torch.decoding.beam import recognize_beam
    cfg, jm, variables, pm, x, _ = emitting
    got = recognize_beam(pm, t(x), T_LEN, max_tokens=20)
    ref = jax_beam.recognize_beam(jm, variables, jnp.asarray(x), jnp.asarray(T_LEN),
                                  max_tokens=20)
    assert got == ref and all(got)


# ---------------------------------------------------------------------------
# int8 serving (the espnet cases of tests/test_quant.py)

@pytest.fixture(scope="module")
def int8(emitting):
    cfg, jm, variables, pm, x, _ = emitting
    vq = jax_quant.quantize_variables(variables)
    return jm.clone(quant=True), vq, to_quant(pm), x


def test_int8_weights_are_the_jax_int8_tree(int8):
    """Every Dense of the JAX espnet model (``linear_pos`` and ``lin_dec``
    bias-free) is a ``QuantLinear`` bit-equal to ``quantize_params``; the
    embeddings and LayerNorms stay float."""
    _, vq, pmq, _ = int8
    n_quant = sum(isinstance(m, quant.QuantLinear) for m in pmq.modules())
    assert n_quant == 3 + 7 * (len(pmq.encoder.encoders) + len(pmq.decoder.encoders))
    assert not any(isinstance(m, torch.nn.Linear) for m in pmq.modules())
    assert isinstance(pmq.decoder.embed[0], torch.nn.Embedding)
    sd, own = from_jax_params(vq["params"]), pmq.state_dict()
    assert set(sd) == set(own)
    for key, value in own.items():
        assert value.dtype == sd[key].dtype and torch.equal(value, sd[key]), key


@pytest.mark.parametrize("input_layer", ["linear", "conv2d"])
def test_int8_input_layers_quantise_as_jax(input_layer):
    """The ``linear`` input layer's projection and the conv stack's ``out``
    are int8; the convolutions stay float (JAX ``quantize_params``)."""
    cfg, _, variables = _layer_model(input_layer)
    pmq = to_quant(port_espnet_model(cfg, variables))
    vq = jax_quant.quantize_variables(variables)
    sd, own = from_jax_params(vq["params"]), pmq.state_dict()
    assert set(sd) == set(own)
    for key, value in own.items():
        assert torch.equal(value, sd[key]), key
    name = "encoder.embed.0" if input_layer == "linear" else "encoder.embed.out.0"
    assert name + ".weight_q" in own
    if input_layer == "conv2d":
        assert own["encoder.embed.conv.0.weight"].dtype == torch.float32


def _jax_int8_encode(jmq, vq, x, t_len):
    return jax.jit(lambda v, xx, ll: jmq.apply(v, xx, ll, method="encode"))(
        vq, jnp.asarray(x), jnp.asarray(t_len))


@pytest.mark.parametrize("use_cache", [True, False])
def test_int8_greedy_matches_jax(int8, use_cache):
    jmq, vq, pmq, x = int8
    ref_enc = _jax_int8_encode(jmq, vq, x, T_LEN)
    rt, rc = jax_greedy_decode(jmq, vq, ref_enc, jnp.asarray(T_LEN), max_tokens=20,
                               use_cache=use_cache, seed_token=V - 1)
    with torch.no_grad():
        enc = pmq.encode(t(x), t(T_LEN))
    gt, gc = greedy_decode(pmq, enc, T_LEN, max_tokens=20, use_cache=use_cache)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    assert (gc > 2).all()
    # W8A8 turns an ulp of a projection's input into a changed int8 step
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc), rtol=0, atol=5e-2)


def test_int8_beam_matches_jax(int8):
    jmq, vq, pmq, x = int8
    ref_enc = _jax_int8_encode(jmq, vq, x, T_LEN)
    rb, rc, rp = jax_beam.beam_search_batched(jmq, vq, ref_enc, jnp.asarray(T_LEN), 5, 20)
    with torch.no_grad():
        enc = pmq.encode(t(x), t(T_LEN))
    gb, gc, gp = beam.beam_search_batched(pmq, enc, T_LEN, 5, 20)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(gp.numpy(), np.asarray(rp), **TOL)
