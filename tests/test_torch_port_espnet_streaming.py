"""PyTorch port: streaming the espnet family — the window, trapezoid and
incremental sessions (``streaming/session.py``), the espnet cached-encoder
step (``streaming/incremental.py``), the batched session
(``streaming/batched.py``) and the ``stream_demo`` and ``serve`` CLIs, held
against the JAX package's espnet sessions on the same weights and audio;
mirrors the espnet tests of ``tests/test_streaming.py``,
``tests/test_incremental_streaming.py`` and ``tests/test_batched_streaming.py``.

Tokens, timestamps and segments identical; encoder rows and confidences
within ``TOL`` (rtol 2e-4, atol 2e-5).
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

from transformer_transducer_tpu.ops import quant as jax_quant
from transformer_transducer_tpu.streaming import batched as jax_batched
from transformer_transducer_tpu.streaming import incremental as jax_incremental
from transformer_transducer_tpu.streaming import session as jax_session
from transformer_transducer_tpu_torch.apps import serve as serve_app
from transformer_transducer_tpu_torch.apps import stream_demo
from transformer_transducer_tpu_torch.data.wav import write_wave
from transformer_transducer_tpu_torch.decoding.greedy import greedy_decode
from transformer_transducer_tpu_torch.models.factory import to_quant
from transformer_transducer_tpu_torch.ops import features_np as F
from transformer_transducer_tpu_torch.streaming import incremental
from transformer_transducer_tpu_torch.streaming.batched import BatchedStreamingSession
from transformer_transducer_tpu_torch.streaming.session import (
    StreamingConfig, StreamingSession, TrapezoidStreamingSession)

from test_torch_port_streaming import assert_same_stream, feed, wave
from torch_port_helpers import (
    N_MELS, TOL, bias_espnet_blank, espnet_train_config, jax_espnet_model,
    port_espnet_model, t, tiny_espnet_cfg)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 20
D_IN = 4 * N_MELS                   # 16 mels x (1 + 3 + 0) stacked frames
GEOM = dict(left_context=3, right_context=2, n_layer=2, feature_dim=N_MELS,
            stack_left=3, win_audio=4800 + 480, audio_step=4800, seed_token=V - 1)


def scfg(**kw):
    return StreamingConfig(**{**GEOM, **kw})


def jax_scfg(**kw):
    return jax_session.StreamingConfig(**{**GEOM, **kw})


def _espnet(input_layer=None, seed=0, share=0.25):
    """(JAX model, variables, port model): the blank biased so that about
    ``share`` of a tone's frames emit at the sos label state.  The
    ``linear`` input layer maps the 64 stacked features to d 32."""
    cfg = tiny_espnet_cfg(input_layer, vocab=V, d=D_IN if input_layer is None else 32,
                          d_in=D_IN)
    jm, variables = jax_espnet_model(cfg, seed=seed)
    pm = port_espnet_model(cfg, variables)
    x = F.subsample(F.stack_frames(F.logmel_masked(wave(40000), 16000, N_MELS), 3, 0), 3)
    with torch.no_grad():
        enc = pm.encode(t(x[None]))
        logits = pm.joint_logits(enc, pm.predict(torch.full((1, 1), V - 1)))
    margin = (logits[0, :, 0, 1:].max(-1).values - logits[0, :, 0, 0]).numpy()
    variables = bias_espnet_blank(variables, float(np.quantile(margin, 1 - share)))
    return jm, variables, port_espnet_model(cfg, variables)


@pytest.fixture(scope="module")
def models():
    return _espnet(seed=3)


@pytest.fixture(scope="module")
def linear_models():
    return _espnet("linear", seed=4)


# ---------------------------------------------------------------------------
# the solo sessions

@pytest.mark.parametrize("hop", [1600, 17000])
def test_window_session_matches_jax(models, hop):
    jm, variables, pm = models
    wav = wave(36000, gate=12000)
    got = feed(StreamingSession(pm, scfg(blank_split=4), device="cpu"), wav, hop)
    ref = feed(jax_session.StreamingSession(jm, variables, jax_scfg(blank_split=4)), wav, hop)
    assert_same_stream(got, ref)
    assert len(got.segments) > 1


def test_espnet_session_matches_offline_greedy(models):
    """Streaming equals the offline greedy decode of the banded encoder
    over the whole utterance (the encodings are shift-invariant, so the
    windows need no pinning; JAX ``tests/test_streaming.py:211``)."""
    _, _, pm = models
    wav = wave(30000)
    session = StreamingSession(pm, scfg(), keep_features=True, device="cpu")
    feed(session, wav, 2500)
    feats = session.feature_log
    with torch.no_grad():
        enc = pm.encode(t(feats[None]))
    tokens, counts = greedy_decode(pm, enc, [feats.shape[0]], max_tokens=200)
    assert session.result == tokens[0, 1:int(counts[0])].tolist() and session.result


@pytest.mark.parametrize("hop", [2500, 7000])
def test_trapezoid_session_matches_jax(models, hop):
    jm, variables, pm = models
    wav = wave(30000)
    got = feed(TrapezoidStreamingSession(pm, scfg(), pred_frame=6, device="cpu"), wav, hop)
    ref = feed(jax_session.TrapezoidStreamingSession(jm, variables, jax_scfg(), pred_frame=6),
               wav, hop)
    assert_same_stream(got, ref)


@pytest.mark.parametrize("layer", [None, "linear"])
def test_incremental_encode_equals_windows_and_jax(models, linear_models, layer):
    """The cached espnet step equals the padded-window encode and the JAX
    step, the final window's key capacity and the input layer on the flush
    zeros included (JAX ``test_espnet_incremental_encode_equals_windows``)."""
    from transformer_transducer_tpu_torch.streaming.session import chunked_encode
    jm, variables, pm = linear_models if layer else models
    L, R, n_layer, tt, fixed = 3, 2, 2, 37, 64
    feats = np.random.default_rng(5).standard_normal((tt, D_IN)).astype(np.float32)
    cfg = scfg(window_len=fixed)
    ref = chunked_encode(pm, feats, cfg, fixed_len=fixed)
    got = incremental.incremental_encode(pm, feats, left=L, right=R, window_len=fixed,
                                         chunk=8)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)
    # the JAX step on the same chunks
    stack, (nl, dm), step = jax_incremental.make_incremental_encoder(
        jm, variables, jax_scfg(window_len=fixed))
    cache = jax_incremental.init_cache(nl, L, R, dm)
    lag = n_layer * R
    kl = jax_incremental.chunked_encode_key_limit(tt, n_layer * L, lag, lag, fixed)
    padded = np.concatenate([feats, np.zeros((lag, D_IN), np.float32)])
    outs, step = [], jax.jit(step)
    for p in range(0, padded.shape[0], 8):
        rows = padded[p:p + 8]
        n = rows.shape[0]
        cache, out, s = step(stack, cache, jnp.asarray(np.pad(rows, ((0, 8 - n), (0, 0)))),
                             jnp.asarray(n, jnp.int32), jnp.asarray(kl, jnp.int32))
        outs += [np.asarray(out)[j] for j in range(n) if 0 <= int(s) + j < tt]
    np.testing.assert_allclose(got, np.stack(outs), **TOL)


@pytest.mark.parametrize("layer", [None, "linear"])
def test_incremental_session_equals_window_session_and_jax(models, linear_models, layer):
    jm, variables, pm = linear_models if layer else models
    wav = wave(30000, gate=9000)
    window = feed(StreamingSession(pm, scfg(blank_split=4), device="cpu"), wav, 4000)
    got = feed(StreamingSession(pm, scfg(blank_split=4), incremental=True, device="cpu"),
               wav, 4000)
    ref = feed(jax_session.StreamingSession(jm, variables, jax_scfg(blank_split=4),
                                            incremental=True), wav, 4000)
    assert_same_stream(got, ref)
    assert (got.result, got.timestamps, got.segments) == \
        (window.result, window.timestamps, window.segments)


def test_conv_input_layers_do_not_stream():
    """A conv-subsampling input layer raises ``ValueError`` in the
    incremental encoder (as in JAX) and in every session."""
    cfg = tiny_espnet_cfg("conv2d", vocab=V, d=32, d_in=D_IN)
    pm = port_espnet_model(cfg, jax_espnet_model(cfg)[1])
    with pytest.raises(ValueError, match="conv2d"):
        incremental.make_incremental_encoder(pm, scfg())
    for make in (lambda: StreamingSession(pm, scfg(), device="cpu"),
                 lambda: BatchedStreamingSession(pm, scfg(), 2, incremental=True,
                                                 device="cpu")):
        with pytest.raises(ValueError, match="conv2d"):
            make()


def test_int8_session_matches_jax(models):
    jm, variables, pm = models
    jmq, vq = jm.clone(quant=True), jax_quant.quantize_variables(variables)
    wav = wave(30000, gate=12000)
    for inc in (False, True):
        got = feed(StreamingSession(to_quant(pm), scfg(blank_split=4), incremental=inc,
                                    device="cpu"), wav, 4000)
        ref = feed(jax_session.StreamingSession(jmq, vq, jax_scfg(blank_split=4),
                                                incremental=inc), wav, 4000)
        assert_same_stream(got, ref)


# ---------------------------------------------------------------------------
# the batched session (tests/test_batched_streaming.py:104)

def _fed(session, wavs):
    for i, w in enumerate(wavs):
        session.accept_waveform(i, w)
        session.finalize(i)
    session.run_to_completion()
    return session


@pytest.mark.parametrize("incremental_mode", [False, True])
@pytest.mark.parametrize("layer", [None, "linear"])
def test_batched_streams_match_jax_and_solo_sessions(models, linear_models, incremental_mode,
                                                     layer):
    jm, variables, pm = linear_models if layer else models
    wavs = [wave(n, seed=s, freq=0.02 + 0.005 * s, gate=9000)
            for s, n in enumerate([24000, 33000, 12000])]
    split = dict(window_len=64, blank_split=4)
    got = _fed(BatchedStreamingSession(pm, scfg(**split), 3, incremental=incremental_mode,
                                       device="cpu"), wavs)
    ref = _fed(jax_batched.BatchedStreamingSession(jm, variables, jax_scfg(**split), n_streams=3,
                                                   incremental=incremental_mode), wavs)
    assert any(st.result for st in ref.streams)
    for i, (g, r) in enumerate(zip(got.streams, ref.streams)):
        assert (g.result, g.timestamps, g.segments) == (r.result, r.timestamps, r.segments)
        np.testing.assert_allclose(g.confidences, r.confidences, **TOL)
        solo = feed(StreamingSession(pm, scfg(**split), device="cpu"), wavs[i], 4000)
        assert g.result == solo.result and g.timestamps == solo.timestamps


def test_serve_files_and_slot_reset(models):
    """Continuous batching of 4 utterances through 2 slots: each equals a
    solo session; a reset slot restarts from the sos seed."""
    _, _, pm = models
    wavs = [wave(n, seed=s, gate=9000) for s, n in enumerate([20000, 9000, 26000, 12000])]
    for inc in (False, True):
        session = BatchedStreamingSession(pm, scfg(blank_split=4), 2, incremental=inc,
                                          device="cpu")
        results = session.serve_files(wavs, rounds_per_call=2)
        for w, res in zip(wavs, results):
            solo = feed(StreamingSession(pm, scfg(blank_split=4), device="cpu"), w, 4000)
            assert res == solo.result
        assert (session._buf[:, 0] == V - 1).all()


# ---------------------------------------------------------------------------
# the CLIs against the root JAX CLIs

def _root_module(folder, name):
    spec = importlib.util.spec_from_file_location(f"ttx_root_{folder}_{name}",
                                                  os.path.join(ROOT, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def served(tmp_path_factory, models):
    """An espnet config (16 mels, d 64) and a JAX checkpoint of ``models``'
    weights, and three waves."""
    from transformer_transducer_tpu.utils import checkpoint as jax_ckpt
    from transformer_transducer_tpu.utils.config import Config as JaxConfig, dump_config
    _, variables, _ = models
    tmp = tmp_path_factory.mktemp("espnet_stream")
    vocab = tmp / "vocab.txt"
    vocab.write_text("<b> 0\n" + "".join(f"w{i} {i}\n" for i in range(1, V)))
    cfg = espnet_train_config(str(tmp), str(vocab), {"train": "x", "dev": "x", "test": "x"},
                              vocab_size=V, d=D_IN)
    cfg["model"] = tiny_espnet_cfg(vocab=V, d=D_IN)
    dump_config(JaxConfig(cfg), str(tmp / "cfg.yaml"))
    ckpt = jax_ckpt.save_checkpoint(str(tmp / "epoch_0"), variables["params"])
    wavs = []
    for i, n in enumerate([30000, 17000, 24000]):
        wavs.append(str(tmp / f"w{i}.wav"))
        write_wave(wavs[-1], wave(n, seed=i, gate=9000))
    return {"cfg": str(tmp / "cfg.yaml"), "ckpt": ckpt, "wavs": wavs}


@pytest.mark.parametrize("flags", [[], ["--incremental"], ["--int8"]])
def test_stream_demo_cli_matches_the_jax_cli(served, monkeypatch, capsys, flags):
    argv = ["--config", served["cfg"], "--checkpoint", served["ckpt"],
            "--wav", served["wavs"][0], "--chunk-ms", "250", *flags]
    text = stream_demo.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["stream_demo.py", *argv])
    _root_module("apps", "stream_demo").main()
    assert text and f"final: {text}\n" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [[], ["--incremental"]])
def test_serve_cli_matches_the_jax_cli(served, monkeypatch, capsys, flags):
    argv = ["--config", served["cfg"], "--checkpoint", served["ckpt"],
            "--wavs", *served["wavs"], "--streams", "2", "--json", *flags]
    serve_app.main(argv + ["--device", "cpu"])
    got = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    _root_module("apps", "serve").main()
    ref = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    assert [g["text"] for g in got] == [r["text"] for r in ref] and any(g["text"] for g in got)
    assert [g["file"] for g in got] == served["wavs"]
