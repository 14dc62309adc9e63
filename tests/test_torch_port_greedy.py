"""PyTorch port: the slice end to end — synthetic int16 waves -> frontend ->
encoder (streaming band, or full context through the flash path) ->
batched greedy decode — held against the JAX package on the same weights.
Tokens must be identical; encoder states within ``TOL`` (rtol 2e-4,
atol 2e-5)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from transformer_transducer_tpu.decoding.greedy import recognize as jax_recognize
from transformer_transducer_tpu.ops import features_np as jax_F
from transformer_transducer_tpu.ops.masks import context_mask as jax_context_mask
from transformer_transducer_tpu_torch.apps import predict as predict_app
from transformer_transducer_tpu_torch.data.wav import write_wave
from transformer_transducer_tpu_torch.decoding.beam import beam_search
from transformer_transducer_tpu_torch.decoding.greedy import (
    greedy_decode, recognize, tokens_to_lists)
from transformer_transducer_tpu_torch.ops import features_np as F

from torch_port_helpers import (
    N_MELS, TOL, bias_blank, jax_model, port_model, t, tiny_model_cfg)

torch.set_num_threads(1)

SECONDS = [1.3, 2.9, 4.45]     # 44, 97 and 149 frames after subsampling


def _wave(seconds, seed):
    rng = np.random.RandomState(seed)
    n = int(seconds * 16000)
    tt = np.arange(n) / 16000.0
    f0 = rng.uniform(120, 400)
    sig = np.sin(2 * np.pi * f0 * tt * (1 + 0.3 * np.sin(2 * np.pi * tt)))
    sig = sig * (0.3 + 0.7 * (np.sin(2 * np.pi * 1.7 * tt) > 0)) + 0.05 * rng.randn(n)
    return (sig * 8000).astype(np.int16)


def _features(F_, wave):
    return F_.subsample(F_.stack_frames(F_.logmel_masked(wave, 16000, N_MELS), 3, 0), 3)


def _batch(feats):
    t_len = np.array([f.shape[0] for f in feats])
    x = np.zeros((len(feats), t_len.max(), feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        x[i, :len(f)] = f
    return x, t_len


@pytest.fixture(scope="module")
def batch():
    waves = [_wave(s, seed=i) for i, s in enumerate(SECONDS)]
    x, t_len = _batch([_features(F, w) for w in waves])
    jx, jt_len = _batch([_features(jax_F, w) for w in waves])
    np.testing.assert_allclose(x, jx, atol=1e-5, rtol=0)
    return x, t_len, jx, jt_len


def _emitting_variables(variables, x, cfg, share=0.3):
    """Bias the blank logit so that about ``share`` of the frames emit at
    the seed label state (untrained weights emit on nearly every frame)."""
    pm = port_model(cfg, variables)
    with torch.no_grad():
        enc = pm.encode(t(x))
        dec = pm.predict(torch.zeros((x.shape[0], 1), dtype=torch.long))
        logits = pm.joint_logits(enc, dec)[:, :, 0]
    margin = logits[..., 1:].max(-1).values - logits[..., 0]
    return bias_blank(variables, float(np.quantile(margin.numpy(), 1 - share)))


@pytest.mark.parametrize("mode", ["band", "full_context"])
def test_recognize_matches_jax(batch, mode):
    x, t_len, jx, jt_len = batch
    cfg = tiny_model_cfg()
    flash = mode == "full_context"
    jm, variables = jax_model(cfg, flash=flash, seed=3)
    variables = _emitting_variables(variables, x, cfg)
    pm = port_model(cfg, variables, flash=flash)
    tmax = x.shape[1]
    mask = None if flash else jax_context_mask(tmax, 10, 2)

    ref = jax_recognize(jm, variables, jnp.asarray(jx), jnp.asarray(jt_len),
                        audio_mask=mask)
    got = recognize(pm, t(x), t_len, band=None if flash else (10, 2))
    assert got == ref
    n_tokens = sum(map(len, got))
    assert 0 < n_tokens < int(t_len.sum()), "some frames emit, some do not"

    ref_enc = jm.apply(variables, jnp.asarray(jx), mask, method="encode")
    with torch.no_grad():
        enc = pm.encode(t(x)) if flash else pm.encode_banded(t(x), 10, 2)
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc), **TOL)


def test_cached_and_uncached_greedy_agree(batch):
    x, t_len, _, _ = batch
    cfg = tiny_model_cfg()
    _, variables = jax_model(cfg, seed=4)
    pm = port_model(cfg, _emitting_variables(variables, x, cfg, share=0.5))
    with torch.no_grad():
        enc = pm.encode_banded(t(x), 10, 2)
    out = [greedy_decode(pm, enc, t_len, max_tokens=9, use_cache=c)
           for c in (True, False)]
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert int(out[0][1].max()) == 9, "the token budget caps emission"
    lists = tokens_to_lists(out[0][0].numpy(), out[0][1].numpy())
    assert all(len(r) <= 8 and 0 not in r for r in lists)


@pytest.mark.parametrize("full_context", [False, True])
def test_predict_cli_on_cpu(tmp_path, batch, full_context):
    cfg = tiny_model_cfg()
    _, variables = jax_model(cfg, seed=5)
    x, _, _, _ = batch
    variables = _emitting_variables(variables, x, cfg, share=0.5)
    pm = port_model(cfg, variables, flash=full_context)
    torch.save(pm.state_dict(), tmp_path / "model.pt")
    with open(tmp_path / "vocab.txt", "w", encoding="utf-8") as fh:
        fh.writelines(f"{'<b>' if i == 0 else chr(0x4e00 + i)} {i}\n"
                      for i in range(50))
    (tmp_path / "config.yaml").write_text(
        "data:\n"
        f"    vocab: {tmp_path / 'vocab.txt'}\n"
        "    left_context_width: 3\n    right_context_width: 0\n"
        f"    feature_dim: {N_MELS}\n    subsample: 3\n"
        "    max_target_length: 42\n"
        "model:\n" + "".join(
            f"    {blk}:\n" + "".join(f"        {k}: {v}\n" for k, v in vals.items())
            if isinstance(vals, dict) else f"    {blk}: {vals}\n"
            for blk, vals in cfg.items()))
    wave = _wave(SECONDS[1], seed=1)
    write_wave(str(tmp_path / "a.wav"), wave)
    argv = ["--config", str(tmp_path / "config.yaml"), "--checkpoint",
            str(tmp_path / "model.pt"), "--wav", str(tmp_path / "a.wav"),
            "--device", "cpu"] + (["--full-context"] if full_context else [])
    text = predict_app.main(argv)

    feats = _features(F, wave)
    tokens = recognize(pm, t(feats[None]), [len(feats)],
                       band=None if full_context else (10, 2))[0]
    assert text == "".join(chr(0x4e00 + i) for i in tokens)
    assert len(text) > 0
    # --beam: the width-5 beam search over the same encoder rows
    with torch.no_grad():
        enc = pm.encode(t(feats[None])) if full_context else pm.encode_banded(
            t(feats[None]), 10, 2)
    beam = beam_search(pm, enc[0], len(feats), beam_width=5, max_tokens=43)
    assert predict_app.main(argv + ["--beam"]) == "".join(chr(0x4e00 + i) for i in beam)
