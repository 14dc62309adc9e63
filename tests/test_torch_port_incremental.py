"""PyTorch port: the cached-encoder (incremental) streaming path
(``streaming/incremental.py`` and the session's ``incremental=True`` mode)
held against the JAX package and against the port's own window path;
mirrors the native tests of ``tests/test_incremental_streaming.py``.

Encoder outputs within ``TOL`` (rtol 2e-4, atol 2e-5); token streams,
timestamps and segments equal.
"""

import copy

import numpy as np
import pytest

import torch

from transformer_transducer_tpu.streaming import incremental as jax_incremental
from transformer_transducer_tpu.streaming import session as jax_session
from transformer_transducer_tpu_torch.streaming import incremental
from transformer_transducer_tpu_torch.streaming.session import (
    StreamingSession, TrapezoidStreamingSession, chunked_encode)

from test_torch_port_streaming import (
    assert_same_stream, emitting_models, feed, jax_scfg, scfg, wave)
from torch_port_helpers import TOL, jax_model, port_model, t, tiny_model_cfg

torch.set_num_threads(1)

FIXED = 64      # the pinned window length, = the tables' k_len here


def _models(n_layer, seed):
    cfg = tiny_model_cfg(enc_layers=n_layer)
    cfg["enc"]["max_input_length"] = FIXED
    jm, variables = jax_model(cfg, seed=seed)
    return jm, variables, port_model(cfg, variables)


@pytest.mark.parametrize("n_layer,left,right,t_len,chunk", [
    (2, 3, 2, 37, 8),
    (3, 4, 2, 50, 16),
    (2, 5, 3, 41, 8),
    (1, 3, 1, 23, 8),
])
def test_incremental_encode_matches_jax_and_chunked(n_layer, left, right, t_len, chunk):
    """The default key_limit reproduces chunked_encode's final window clip."""
    jm, variables, pm = _models(n_layer, seed=n_layer + left)
    feats = np.random.RandomState(left + right).randn(t_len, 64).astype(np.float32)
    got = incremental.incremental_encode(pm, feats, left=left, right=right,
                                         window_len=FIXED, chunk=chunk)
    ref = jax_incremental.incremental_encode(jm, variables, feats, left=left, right=right,
                                             window_len=FIXED, chunk=chunk)
    assert got.shape == ref.shape == (t_len, 64)
    np.testing.assert_allclose(got, ref, **TOL)
    cfg = scfg(left_context=left, right_context=right, n_layer=n_layer)
    np.testing.assert_allclose(got, chunked_encode(pm, feats, cfg, fixed_len=FIXED), **TOL)


def test_incremental_encode_with_the_window_key_limit_is_the_padded_encode():
    """With ``key_limit`` at the window's capacity, the stream equals one
    banded encode of the zero-padded window (the flush rows are its pad)."""
    _, _, pm = _models(2, seed=1)
    feats = np.random.RandomState(3).randn(45, 64).astype(np.float32)
    got = incremental.incremental_encode(pm, feats, left=10, right=2, window_len=FIXED,
                                         chunk=16, key_limit=FIXED)
    padded = np.zeros((1, FIXED, 64), np.float32)
    padded[0, :45] = feats
    with torch.no_grad():
        ref = pm.encode_banded(t(padded), 10, 2)[0, :45].numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_incremental_encode_chunk_size_invariant():
    _, _, pm = _models(2, seed=7)
    feats = np.random.RandomState(5).randn(45, 64).astype(np.float32)
    outs = [incremental.incremental_encode(pm, feats, left=3, right=2, window_len=FIXED,
                                           chunk=c) for c in (4, 16, 45)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-5, atol=1e-6)


def test_invalid_cache_rows_do_not_reach_the_outputs():
    """Rows at negative positions (and past the key limit) are zeroed before
    the products: NaN in them must not ride the V product (0 * NaN)."""
    _, _, pm = _models(2, seed=2)
    layers, (n_layer, d_model), step = incremental.make_incremental_encoder(
        pm, scfg(window_len=FIXED))
    rows = torch.from_numpy(np.random.RandomState(4).randn(12, 64).astype(np.float32))
    clean = incremental.init_cache(n_layer, 10, 2, d_model)
    dirty = copy.deepcopy(clean)
    dirty["bufs"].fill_(float("nan"))
    with torch.no_grad():
        _, a, start = step(layers, clean, rows, 9)
        _, b, _ = step(layers, dirty, rows, 9)
    assert start == -4 and bool(torch.isfinite(b).all())
    assert torch.equal(a, b)


def _wav(n, seed=9):
    return (np.random.RandomState(seed).randn(n) * 3000).astype(np.int16)


@pytest.fixture(scope="module")
def session_models():
    return emitting_models(seed=11, share=0.3)


@pytest.mark.parametrize("n_audio,hop", [(30000, 4000), (52000, 17000), (30000, 1600)])
def test_incremental_session_equals_window_session_and_jax(session_models, n_audio, hop):
    """The cached-encoder session emits the window session's tokens, splits
    and timestamps under the same feed pattern (including the final
    window's key clip), and the JAX incremental session's."""
    jm, variables, pm = session_models
    wav = wave(n_audio, gate=12000)
    window = feed(StreamingSession(pm, scfg(blank_split=4), device="cpu"), wav, hop)
    got = feed(StreamingSession(pm, scfg(blank_split=4), device="cpu", incremental=True),
               wav, hop)
    ref = feed(jax_session.StreamingSession(jm, variables, jax_scfg(blank_split=4),
                                            incremental=True), wav, hop)
    assert_same_stream(got, ref)
    assert got.result == window.result and got.segments == window.segments
    assert got.timestamps == window.timestamps
    np.testing.assert_allclose(got.confidences, window.confidences, rtol=1e-4, atol=1e-5)


def test_incremental_session_feed_pattern_invariant(session_models):
    _, _, pm = session_models
    wav = _wav(30000, seed=13)
    a = feed(StreamingSession(pm, scfg(), device="cpu", incremental=True), wav, 1600)
    b = feed(StreamingSession(pm, scfg(), device="cpu", incremental=True), wav, len(wav))
    assert a.result and a.result == b.result


def test_incremental_session_keeps_host_buffers_bounded(session_models):
    """Fed rows are dropped from the host buffer; the cache is per layer."""
    _, _, pm = session_models
    cfg = scfg()
    session = StreamingSession(pm, cfg, device="cpu", incremental=True)
    rng = np.random.RandomState(3)
    for _ in range(10):
        session.accept_waveform((rng.randn(16000) * 3000).astype(np.int16))
        assert session.subsampled.shape[0] <= cfg.new_frames * 4
        assert session._cache["bufs"].shape == (2, 12, 64)
    session.finalize()
    assert session._fed == session._sub_base + session.subsampled.shape[0] + cfg.right_len


def test_incremental_rejects_trapezoid(session_models):
    _, _, pm = session_models
    with pytest.raises(ValueError):
        TrapezoidStreamingSession(pm, scfg(), incremental=True, device="cpu")


def test_incremental_encoder_rejects_other_families():
    with pytest.raises(NotImplementedError, match="later slice"):
        incremental.make_incremental_encoder(torch.nn.Linear(2, 2), scfg())
