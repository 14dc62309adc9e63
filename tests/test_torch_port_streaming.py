"""PyTorch port: the streaming sessions (``streaming/session.py``) held against
the JAX package's on the same weights and the same int16 audio; mirrors
``tests/test_streaming.py`` (its jit-only program-size test has no
counterpart; the espnet family's sessions are in
``tests/test_torch_port_espnet_streaming.py``).

Tokens, timestamps and segments must be equal; confidences and encoder
states within ``TOL`` (rtol 2e-4, atol 2e-5: the same fp32 math in another
summation order).  Shapes are small: 2 encoder layers, d_model 64 (16 mels
x 4 stacked frames), band (10, 2).
"""

import os

import numpy as np
import pytest

import torch

from transformer_transducer_tpu.ops import features_np as jax_F
from transformer_transducer_tpu.streaming import session as jax_session
from transformer_transducer_tpu.utils.config import load_config as jax_load_config
from transformer_transducer_tpu_torch.apps import stream_demo
from transformer_transducer_tpu_torch.data.wav import write_wave
from transformer_transducer_tpu_torch.decoding.greedy import greedy_decode, tokens_to_lists
from transformer_transducer_tpu_torch.models.factory import to_quant
from transformer_transducer_tpu_torch.ops import features_np as F
from transformer_transducer_tpu_torch.streaming.session import (
    StreamingConfig, StreamingSession, TrapezoidStreamingSession,
    advance_window_geometry, chunked_encode, pack_decode_outputs)
from transformer_transducer_tpu_torch.utils.config import load_config

from torch_port_helpers import N_MELS, TOL, bias_blank, jax_model, port_model, t, tiny_model_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM = dict(left_context=10, right_context=2, n_layer=2, feature_dim=N_MELS,
            stack_left=3, win_audio=4800 + 480, audio_step=4800)


def wave(n, seed=9, freq=0.03, gate=None):
    """A tone in noise; with ``gate`` (samples), silent for about 40 % of
    each period, so that runs of blank frames split sentences."""
    rng = np.random.RandomState(seed)
    x = np.sin(np.arange(n) * freq) * 9000 + rng.randn(n) * 1500
    if gate:
        x *= np.sin(2 * np.pi * np.arange(n) / gate) > -0.2
    return x.astype(np.int16)


def scfg(**kw):
    """The test geometry as the port's ``StreamingConfig``."""
    return StreamingConfig(**{**GEOM, **kw})


def jax_scfg(**kw):
    """The same as the JAX package's."""
    return jax_session.StreamingConfig(**{**GEOM, **kw})


def feed(session, wav, hop):
    out = []
    for i in range(0, len(wav), hop):
        out += session.accept_waveform(wav[i:i + hop])
    out += session.finalize()
    assert out == session.result
    return session


def emitting_models(seed, share=0.2):
    """JAX and port models on one set of weights, the blank logit biased so
    that about ``share`` of the frames emit at the seed label state
    (untrained weights emit on nearly every frame)."""
    cfg = tiny_model_cfg()
    jm, variables = jax_model(cfg, seed=seed)
    pm = port_model(cfg, variables)
    x = F.subsample(F.stack_frames(F.logmel_masked(wave(40000), 16000, N_MELS), 3, 0), 3)
    with torch.no_grad():
        enc = pm.encode_banded(t(x[None]), 10, 2)
        logits = pm.joint_logits(enc, pm.predict(torch.zeros((1, 1), dtype=torch.long)))
    margin = (logits[0, :, 0, 1:].max(-1).values - logits[0, :, 0, 0]).numpy()
    variables = bias_blank(variables, float(np.quantile(margin, 1 - share)))
    return jm, variables, port_model(cfg, variables)


@pytest.fixture(scope="module")
def models():
    return emitting_models(seed=3)


def assert_same_stream(got, ref):
    assert ref.result, "degenerate test: nothing was emitted"
    assert got.result == ref.result
    assert got.timestamps == ref.timestamps
    assert got.segments == ref.segments
    np.testing.assert_allclose(got.confidences, ref.confidences, **TOL)


@pytest.mark.parametrize("last_clip", [False, True])
def test_advance_window_geometry_matches_jax(last_clip):
    cfg, jcfg = scfg(window_len=64), jax_scfg(window_len=64)
    for pos in range(0, 120, 7):
        for total in range(0, 200, 9):
            for final_start in (None, 3):
                got = advance_window_geometry(pos, final_start, total, last_clip, cfg)
                ref = jax_session.advance_window_geometry(pos, final_start, total,
                                                          last_clip, jcfg)
                assert got == ref, (pos, total, final_start)


def test_streaming_config_lengths():
    cfg = StreamingConfig.from_config(load_config(os.path.join(ROOT, "configs",
                                                               "joint_streaming.yaml")))
    ref = jax_session.StreamingConfig.from_config(jax_load_config(
        os.path.join(ROOT, "configs", "joint_streaming.yaml")))
    cfg.ensure_lengths()
    ref.ensure_lengths()
    assert (cfg.left_len, cfg.new_frames, cfg.right_len) == (180, 36, 36)
    assert (cfg.window_len, cfg.chunk_len) == (256, 40)
    assert cfg == StreamingConfig(**{f: getattr(ref, f) for f in vars(ref)})
    kept = StreamingConfig(window_len=320, chunk_len=8)
    kept.ensure_lengths()
    assert (kept.window_len, kept.chunk_len) == (320, 8)


def test_espnet_family_waits_for_a_later_slice():
    """The espnet family streams now (JAX ``StreamingConfig.from_config``'s
    espnet branch): band from ``model.mask``, ``enc.num_blocks`` layers, the
    sos seed."""
    from transformer_transducer_tpu.streaming.session import (
        StreamingConfig as JaxStreamingConfig)
    from transformer_transducer_tpu.utils.config import load_config as jax_load_config
    path = os.path.join(ROOT, "configs", "espnet_aishell.yaml")
    got = StreamingConfig.from_config(load_config(path))
    ref = JaxStreamingConfig.from_config(jax_load_config(path))
    assert vars(got) == vars(ref) and got.seed_token == 4232


def test_pack_decode_outputs_is_exact():
    out = pack_decode_outputs(torch.tensor([0, 6484, 3]), torch.tensor([False, True, False]),
                              torch.tensor([0.0, -0.25, -1.5]))
    assert out.dtype == torch.float32 and out.shape == (3, 3)
    assert out[0].long().tolist() == [0, 6484, 3] and out[1].tolist() == [0.0, 1.0, 0.0]


# 64 < k_len 120 < 160: the longer window front-pads the tables with row 0
@pytest.mark.parametrize("fixed_len,n_frames", [(64, 57), (160, 150)])
def test_chunked_encode_matches_jax_and_full_banded(models, fixed_len, n_frames):
    """Receptive-field halo windows reproduce full-sequence banded encoding
    at the same padded length, as the JAX ``chunked_encode`` does."""
    jm, variables, pm = models
    feats = np.random.RandomState(0).randn(n_frames, 64).astype(np.float32)
    got = chunked_encode(pm, feats, scfg(), fixed_len=fixed_len)
    ref = jax_session.chunked_encode(jm, variables, feats, jax_scfg(), fixed_len=fixed_len)
    assert got.shape == ref.shape == (n_frames, 64)
    np.testing.assert_allclose(got, ref, **TOL)
    padded = np.zeros((1, fixed_len, 64), np.float32)
    padded[0, :n_frames] = feats
    with torch.no_grad():
        full = pm.encode_banded(t(padded), 10, 2)[0, :n_frames].numpy()
    np.testing.assert_allclose(got, full, **TOL)


def test_window_padding_does_not_leak(models):
    """Padding past a window cannot change its effective frames: the band
    bounds the receptive field (2 layers x right 2 = 4 future frames)."""
    _, _, pm = models
    rng = np.random.RandomState(1)
    zeros = np.zeros((1, 64, 64), np.float32)
    zeros[0, :40] = rng.randn(40, 64)
    garbage = zeros.copy()
    garbage[0, 40:] = rng.randn(24, 64) * 5
    with torch.no_grad():
        ref = pm.encode_banded(t(zeros), 10, 2)[0, :36]
        got = pm.encode_banded(t(garbage), 10, 2)[0, :36]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_feature_pipeline_matches_jax_and_offline(models):
    """With a hop that is a multiple of the frame hop and the subsample
    period, the smoothed feature stream equals the JAX session's and starts
    as the offline features do."""
    jm, variables, pm = models
    wav = (np.random.RandomState(2).randn(16000) * 3000).astype(np.int16)
    got = feed(StreamingSession(pm, scfg(), keep_features=True, device="cpu"), wav,
               1600).feature_log
    ref = feed(jax_session.StreamingSession(jm, variables, jax_scfg(), keep_features=True),
               wav, 1600).feature_log
    assert got.shape == ref.shape and got.shape[0] > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    offline = jax_F.subsample(jax_F.stack_frames(jax_F.logmel_masked(wav, 16000, N_MELS),
                                                 3, 0), 3)
    np.testing.assert_allclose(got[:5], offline[:5], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hop", [1600, 4000, 17000, 60000])
def test_window_session_matches_jax(models, hop):
    jm, variables, pm = models
    wav = wave(40000, gate=12000)
    got = feed(StreamingSession(pm, scfg(blank_split=4), device="cpu"), wav, hop)
    ref = feed(jax_session.StreamingSession(jm, variables, jax_scfg(blank_split=4)),
               wav, hop)
    assert_same_stream(got, ref)


def test_window_session_matches_offline_greedy(models):
    """A short utterance: the streamed tokens equal offline banded encoding
    at the session's window length + the port's greedy decode."""
    _, _, pm = models
    wav = wave(12000, seed=4)
    session = feed(StreamingSession(pm, scfg(window_len=64), keep_features=True,
                                    device="cpu"), wav, 3000)
    feats = session.feature_log
    assert feats.shape[0] <= 64
    padded = np.zeros((1, 64, 64), np.float32)
    padded[0, :feats.shape[0]] = feats
    with torch.no_grad():
        enc = pm.encode_banded(t(padded), 10, 2)
    tokens, counts = greedy_decode(pm, enc, [feats.shape[0]], max_tokens=41)
    offline = tokens_to_lists(tokens.numpy(), counts.numpy())[0]
    assert session.result and session.result == offline


@pytest.mark.parametrize("hop", [2500, 7000])
def test_trapezoid_session_matches_jax_and_covers_all_frames(models, hop):
    jm, variables, pm = models
    wav = wave(30000, seed=7, gate=12000)
    session = TrapezoidStreamingSession(pm, scfg(blank_split=4), pred_frame=10,
                                        device="cpu")
    assert session.min_win == 10 + 4 and session.max_win == 20 + 10 + 4
    got = feed(session, wav, hop)
    ref = feed(jax_session.TrapezoidStreamingSession(jm, variables, jax_scfg(blank_split=4),
                                                     pred_frame=10), wav, hop)
    assert_same_stream(got, ref)
    assert all(b > a for a, b in zip(got.timestamps, got.timestamps[1:]))
    assert got.win_len == got.max_win      # the window finished growing
    total = got._sub_base + got.subsampled.shape[0]
    consumed = got.win_feature_position + got.win_len - got.min_win
    assert got.win_feature_position == total or consumed >= total
    assert got.window_groups == got.windows    # one window a group


@pytest.mark.parametrize("blank_split", [2, 4])
def test_sentence_split_on_blank_run(models, blank_split):
    """Segments partition the result and split where the JAX session's do
    (the blank run counts only after the first token)."""
    jm, variables, pm = models
    wav = wave(30000, seed=7, gate=12000)
    got = feed(StreamingSession(pm, scfg(blank_split=blank_split), device="cpu"),
               wav, 30000)
    ref = feed(jax_session.StreamingSession(jm, variables,
                                            jax_scfg(blank_split=blank_split)), wav, 30000)
    assert sum(got.segments, []) == got.result
    assert len(got.segments) > 1, "degenerate test: no split"
    assert_same_stream(got, ref)


def test_token_timestamps_are_frame_aligned(models):
    """One timestamp and one confidence per token, strictly increasing
    frames inside the consumed range, the same on the incremental path."""
    _, _, pm = models
    wav = wave(30000, seed=11)
    ref = feed(StreamingSession(pm, scfg(blank_split=4), device="cpu"), wav, 4000)
    assert ref.result, "degenerate test: nothing emitted"
    assert len(ref.timestamps) == len(ref.confidences) == len(ref.result)
    assert all(b > a for a, b in zip(ref.timestamps, ref.timestamps[1:]))
    assert 0 <= ref.timestamps[0] and ref.timestamps[-1] < ref._sub_base + ref.subsampled.shape[0]
    assert all(c <= 0.0 for c in ref.confidences)
    inc = feed(StreamingSession(pm, scfg(blank_split=4), device="cpu", incremental=True),
               wav, 4000)
    assert inc.result == ref.result and inc.timestamps == ref.timestamps
    np.testing.assert_allclose(inc.confidences, ref.confidences, rtol=1e-4, atol=1e-5)


def test_long_stream_host_buffers_stay_bounded(models):
    """A long stream holds O(halo) host state: buffers are trimmed as they
    are consumed while positions stay absolute."""
    _, _, pm = models
    cfg = scfg(window_len=64)
    session = StreamingSession(pm, cfg, device="cpu")
    rng = np.random.RandomState(9)
    seconds = 40
    for _ in range(seconds):
        session.accept_waveform((rng.randn(16000) * 3000).astype(np.int16))
        assert len(session.audio) <= cfg.win_audio + 16000
        assert session.subsampled.shape[0] <= cfg.window_len * 4
        assert session.log_mel.shape[0] <= cfg.stack_left
    session.finalize()
    assert session.win_audio_position > 16000 * (seconds - 2)
    assert session._sub_base + session.subsampled.shape[0] == session.win_feature_position


@pytest.mark.parametrize("incremental", [False, True])
def test_host_reads_at_most_emissions_plus_windows(models, incremental):
    """The frame decoder reads the device once per joint: at most once an
    emission plus once a window (an incremental step)."""
    _, _, pm = models
    session = feed(StreamingSession(pm, scfg(), device="cpu", incremental=incremental),
                   wave(40000), 4000)
    assert session.result and session.windows > 1
    assert session.host_reads <= len(session.result) + session.windows
    assert session.host_reads >= session.windows
    if not incremental:
        assert session.window_groups <= session.windows


@pytest.mark.parametrize("incremental", [False, True])
def test_stream_demo_cli_on_cpu(tmp_path, capsys, monkeypatch, models, incremental):
    """``stream_demo --device cpu`` on a generated wav with a port
    checkpoint: its text is the session's tokens through the vocabulary."""
    _, _, pm = models
    torch.save(pm.state_dict(), tmp_path / "model.pt")
    with open(tmp_path / "vocab.txt", "w", encoding="utf-8") as fh:
        fh.writelines(f"{'<b>' if i == 0 else chr(0x4e00 + i)} {i}\n" for i in range(50))
    cfg = tiny_model_cfg()
    (tmp_path / "config.yaml").write_text(
        "data:\n"
        f"    vocab: {tmp_path / 'vocab.txt'}\n"
        "    left_context_width: 3\n    right_context_width: 0\n"
        f"    feature_dim: {N_MELS}\n    subsample: 3\n"
        "model:\n" + "".join(
            f"    {blk}:\n" + "".join(f"        {k}: {v}\n" for k, v in vals.items())
            if isinstance(vals, dict) else f"    {blk}: {vals}\n"
            for blk, vals in cfg.items()))
    wav = wave(40000, seed=5)
    write_wave(str(tmp_path / "a.wav"), wav)
    argv = ["--config", str(tmp_path / "config.yaml"), "--checkpoint",
            str(tmp_path / "model.pt"), "--wav", str(tmp_path / "a.wav"),
            "--device", "cpu", "--rtf", "--timestamps", "--chunk-ms", "250"]
    text = stream_demo.main(argv + (["--incremental"] if incremental else []))
    printed = capsys.readouterr().out
    ref = feed(StreamingSession(pm, StreamingConfig(n_layer=2, feature_dim=N_MELS),
                                device="cpu"), wav, 4000)
    assert ref.result and text == "".join(chr(0x4e00 + i) for i in ref.result)
    assert f"final: {text}" in printed and "RTF" in printed
    assert printed.count("p=") == len(ref.result)
    # --int8: the W8A8 twin's session, fed the same
    text = stream_demo.main(argv + ["--int8"] + (["--incremental"] if incremental else []))
    capsys.readouterr()
    ref = feed(StreamingSession(to_quant(pm), StreamingConfig(n_layer=2, feature_dim=N_MELS),
                                device="cpu", incremental=incremental), wav, 4000)
    assert ref.result and text == "".join(chr(0x4e00 + i) for i in ref.result)
    # --gui hands the session to the Tk window (apps/gui.py), fed from the file
    from transformer_transducer_tpu_torch.apps import gui
    opened = []

    class Window:
        def __init__(self, session, vocab):
            opened.append(session)

        def set_wav_source(self, path, chunk_ms):
            opened.append((path, chunk_ms))

        def run(self):
            opened.append("run")

    monkeypatch.setattr(gui, "StreamGui", Window)
    stream_demo.main(argv + ["--gui"])
    assert isinstance(opened[0], StreamingSession)
    assert opened[1:] == [(str(tmp_path / "a.wav"), 250), "run"]
