"""PyTorch port: the width-5 beam search (``decoding/beam.py``) and the
reference oracles, held against the JAX package on the same weights and
encoder rows; mirrors ``tests/test_beam.py`` (not its torch-reference
test, which needs the upstream model).  Tokens and counts must be
identical; scores within ``TOL`` (rtol 2e-4, atol 2e-5)."""

import copy
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.decoding import beam as jax_beam
from transformer_transducer_tpu.decoding import greedy as jax_greedy
from transformer_transducer_tpu.ops.masks import context_mask as jax_context_mask
from transformer_transducer_tpu_torch.apps import predict as predict_app
from transformer_transducer_tpu_torch.data.wav import write_wave
from transformer_transducer_tpu_torch.decoding import beam
from transformer_transducer_tpu_torch.decoding.greedy import decode_reference_exact

from torch_port_helpers import TOL, bias_blank, jax_model, port_model, t, tiny_model_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 12
T_LEN = [40, 27, 33]


def _emitting(cfg, variables, enc, share):
    """Bias the blank logit so that about ``share`` of the frames emit at
    the seed label state."""
    pm = port_model(cfg, variables)
    with torch.no_grad():
        dec = pm.predict(torch.zeros((enc.shape[0], 1), dtype=torch.long))
        logits = pm.joint_logits(t(enc), dec)[:, :, 0]
    margin = logits[..., 1:].max(-1).values - logits[..., 0]
    return bias_blank(variables, float(np.quantile(margin.numpy(), 1 - share)))


def _problem(seed, share=0.4):
    """(cfg, JAX model, variables, port model, encoder rows (B, T, D))."""
    cfg = tiny_model_cfg(vocab=V)
    jm, variables = jax_model(cfg, seed=seed)
    enc = np.random.default_rng(seed).standard_normal((3, max(T_LEN), 64)).astype(np.float32)
    variables = _emitting(cfg, variables, enc, share)
    return cfg, jm, variables, port_model(cfg, variables), enc


def _both(jm, variables, pm, enc, max_tokens, use_cache):
    ref = jax_beam.beam_search_batched(jm, variables, jnp.asarray(enc),
                                       jnp.asarray(T_LEN), 5, max_tokens, 0, use_cache)
    stats = {}
    got = beam.beam_search_batched(pm, t(enc), T_LEN, 5, max_tokens, use_cache=use_cache,
                                   stats=stats)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got], stats


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_beam_search_batched_matches_jax(seed, use_cache):
    _, jm, variables, pm, enc = _problem(seed)
    (rb, rc, rp), (gb, gc, gp), stats = _both(jm, variables, pm, enc, 43, use_cache)
    np.testing.assert_array_equal(gb, rb)
    np.testing.assert_array_equal(gc, rc)
    np.testing.assert_allclose(gp, rp, **TOL)
    assert (gc[:, 0] > 1).all() and (gc[:, 0] - 1 < np.array(T_LEN)).all(), \
        "some frames expand, some do not"
    # one read of the card an iteration; iterations about the most
    # expansions of one row plus T / GATE_CHUNK
    assert stats["host_reads"] == stats["iterations"]
    assert stats["iterations"] <= int(gc[:, 0].max()) - 1 + -(-max(T_LEN) // beam.GATE_CHUNK) + 1


@pytest.mark.parametrize("use_cache", [True, False])
def test_rows_that_skip_a_window_keep_their_state(use_cache):
    """Sparse emissions over long rows: iterations where one row expands
    while another skips a whole gate window without an emission; the row
    that did not expand keeps its beams, scores and label cache."""
    cfg = tiny_model_cfg(vocab=V)
    jm, variables = jax_model(cfg, seed=8)
    t_len = [110, 96, 120]
    enc = np.random.default_rng(8).standard_normal((3, 120, 64)).astype(np.float32)
    variables = _emitting(cfg, variables, enc, 0.04)
    pm = port_model(cfg, variables)
    ref = jax_beam.beam_search_batched(jm, variables, jnp.asarray(enc), jnp.asarray(t_len),
                                       5, 43, 0, use_cache)
    steps = []
    got = beam.beam_search_batched(pm, t(enc), t_len, 5, 43, use_cache=use_cache,
                                   observe=steps.append)
    live = torch.tensor(t_len)
    skipped = [bool(s["expand"].any()) and bool((~s["expand"] & ~s["first"]
                                                  & (s["cur_t"] < live)).any()) for s in steps]
    assert any(skipped), "a live row skips a window while another expands"
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), **TOL)


def test_cache_matches_recompute():
    _, _, _, pm, enc = _problem(5, share=0.6)
    cached = beam.beam_search_batched(pm, t(enc), T_LEN, 5, 43, use_cache=True)
    plain = beam.beam_search_batched(pm, t(enc), T_LEN, 5, 43, use_cache=False)
    assert torch.equal(cached[0], plain[0]) and torch.equal(cached[1], plain[1])
    np.testing.assert_allclose(cached[2].numpy(), plain[2].numpy(), **TOL)


@pytest.mark.parametrize("use_cache", [True, False])
def test_token_cap_binds_with_the_parent_score(use_cache):
    """``max_tokens`` small enough that buffers fill: a full buffer keeps
    its parent's score (no phantom credit), as in JAX."""
    _, jm, variables, pm, enc = _problem(6, share=0.6)
    (rb, rc, rp), (gb, gc, gp), _ = _both(jm, variables, pm, enc, 5, use_cache)
    assert (gc == 5).any(), "the cap binds"
    np.testing.assert_array_equal(gb, rb)
    np.testing.assert_array_equal(gc, rc)
    np.testing.assert_allclose(gp, rp, **TOL)


@pytest.mark.parametrize("mode", ["band", "full_context"])
def test_recognize_beam_matches_jax(mode):
    cfg = tiny_model_cfg(vocab=V)
    jm, variables = jax_model(cfg, seed=7)
    x = np.random.default_rng(7).standard_normal((3, max(T_LEN), 64)).astype(np.float32)
    variables = _emitting(cfg, variables, x, 0.4)
    pm = port_model(cfg, variables)
    mask = None if mode == "full_context" else jax_context_mask(max(T_LEN), 10, 2)
    ref = jax_beam.recognize_beam(jm, variables, jnp.asarray(x), jnp.asarray(T_LEN),
                                  audio_mask=mask, max_tokens=43)
    stats = {}
    got = beam.recognize_beam(pm, t(x), T_LEN, band=None if mask is None else (10, 2),
                              max_tokens=43, stats=stats)
    assert got == ref and any(got)
    assert stats["host_reads"] == stats["iterations"]


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_exact_oracles_match_jax(seed):
    """``decode_reference_exact`` and ``beam_search_reference_exact`` (the
    reference's unmasked loops, one utterance) against the JAX oracles."""
    _, jm, variables, pm, enc = _problem(seed, share=0.5)
    n = 14
    one = enc[0, :n]
    assert decode_reference_exact(pm, t(one), n) == \
        jax_greedy.decode_reference_exact(jm, variables, one, n)
    got = beam.beam_search_reference_exact(pm, t(one), n)
    assert got and got == jax_beam.beam_search_reference_exact(jm, variables, one, n)


def test_espnet_joint_raises():
    """An espnet joint no longer raises: the search runs it as JAX does
    (``tests/test_torch_port_espnet.py`` holds it to JAX's); a joint of
    neither family raises ``ValueError``."""
    from torch_port_helpers import jax_espnet_model, port_espnet_model, tiny_espnet_cfg
    _, _, _, pm, enc = _problem(0)
    cfg = tiny_espnet_cfg(vocab=V, d=64)
    esp = port_espnet_model(cfg, jax_espnet_model(cfg)[1])
    beams, counts, _ = beam.beam_search_batched(esp, t(enc), T_LEN)
    assert (beams[:, :, 0] == V - 1).all() and (counts >= 1).all()
    odd = copy.deepcopy(pm)
    del odd.joint.forward_layer
    with pytest.raises(ValueError, match="unrecognized joint"):
        beam.beam_search_batched(odd, t(enc), T_LEN)


def _root_predict():
    spec = importlib.util.spec_from_file_location(
        "ttx_root_predict", os.path.join(ROOT, "apps", "predict.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("full_context", [False, True])
def test_predict_beam_cli_matches_the_jax_cli(tmp_path, monkeypatch, capsys, full_context):
    """``apps/predict.py --beam --device cpu`` and the root JAX CLI's
    ``--beam`` on one JAX checkpoint directory: the same text."""
    from transformer_transducer_tpu.utils import checkpoint as jax_ckpt
    from transformer_transducer_tpu.utils.config import dump_config

    from data_helpers import tiny_train_config
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("<b> 0\n" + "".join(f"w{i} {i}\n" for i in range(1, 12)))
    cfg = tiny_train_config(str(tmp_path), str(vocab), {"train": "x", "dev": "x", "test": "x"})
    dump_config(cfg, str(tmp_path / "cfg.yaml"))
    from transformer_transducer_tpu.models.factory import build_family
    _, variables, _ = build_family(cfg, 16)
    ckpt = jax_ckpt.save_checkpoint(str(tmp_path / "ck"), variables["params"])
    rng = np.random.RandomState(0)
    n = 24000
    write_wave(str(tmp_path / "a.wav"), np.sin(np.arange(n) * 0.02) * 9000 + rng.randn(n) * 1500)
    argv = ["--config", str(tmp_path / "cfg.yaml"), "--checkpoint", ckpt,
            "--wav", str(tmp_path / "a.wav"), "--beam"] + (
                ["--full-context"] if full_context else [])
    text = predict_app.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["predict.py", *argv])
    _root_predict().main()
    out = capsys.readouterr().out
    assert text and f"prediction: {text}\n" in out
