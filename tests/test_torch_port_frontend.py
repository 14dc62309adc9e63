"""PyTorch port: host frontend, config reader, vocabulary, metrics and WAV
I/O held against the JAX package (and PyYAML)."""

import glob
import io
import os

import numpy as np
import pytest
import torch
import yaml

from transformer_transducer_tpu.ops import features_np as jax_F
from transformer_transducer_tpu.utils.metrics import (
    _levenshtein_numpy as jax_levenshtein)
from transformer_transducer_tpu_torch.data.wav import read_wave, write_wave
from transformer_transducer_tpu_torch.ops import features_np as F
from transformer_transducer_tpu_torch.ops.masks import context_mask, look_ahead_mask
from transformer_transducer_tpu_torch.utils import config as C
from transformer_transducer_tpu_torch.utils.metrics import batch_cer, levenshtein
from transformer_transducer_tpu_torch.utils.vocab import Vocabulary

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def _wave(n, seed):
    rng = np.random.RandomState(seed)
    sig = np.sin(2 * np.pi * 220 * np.arange(n) / 16000) + 0.1 * rng.randn(n)
    return (sig * 6000).astype(np.int16)


@pytest.mark.parametrize("variant", ["masked", "eps"])
@pytest.mark.parametrize("n", [400, 16000, 35711])
def test_features_match_jax(variant, n):
    wave = _wave(n, seed=n)
    got = F.extract(wave, n_mels=128, log_variant=variant)
    ref = jax_F.extract(wave, n_mels=128, log_variant=variant)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("t_frames,left,right", [(2, 3, 0), (9, 3, 0), (9, 2, 2)])
def test_stack_frames_matches_jax(t_frames, left, right):
    x = np.random.RandomState(t_frames).randn(t_frames, 5).astype(np.float32)
    np.testing.assert_array_equal(F.stack_frames(x, left, right),
                                  jax_F.stack_frames(x, left, right))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_matches_pyyaml(path):
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    assert C.parse_yaml(text) == yaml.safe_load(text)


def test_yaml_reader_scalars_and_errors():
    text = ("a: 1\nb: 1.5\nc: True\nd: off\ne:\nf: null\ng: 'x # y'\n"
            "h: 1e-5\ni: 1.0e-5\nj: -3\nk: text # comment\nl:\n  m: 0x1f\n")
    assert C.parse_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ValueError):
        C.parse_yaml("a:\n    b: 1\n  c: 2\n")


def test_config_contract():
    cfg = C.load_config(io.StringIO("model:\n  enc:\n    n_layer: 2\n"),
                        overrides={"model.dec.n_layer": 1})
    assert cfg.model.enc.n_layer == 2 and cfg.model.dec.n_layer == 1
    assert cfg.model.share_embedding is None          # missing key -> None
    C.apply_overrides(cfg, ["data.subsample=4", "data.vocab=v.txt"])
    assert C.subsample_factor(cfg.data) == 4 and cfg.data.vocab == "v.txt"
    assert C.stack_context(cfg.data) == (3, 0)
    cfg.data.left_context_width = 0
    assert C.stack_context(cfg.data) == (0, 0)


def test_masks():
    m = context_mask(6, 2, 1)
    i, j = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    np.testing.assert_array_equal(m.numpy(), (j - i > 1) | (i - j > 2))
    np.testing.assert_array_equal(context_mask(4, -1, 0).numpy(), j[:4, :4] > i[:4, :4])
    np.testing.assert_array_equal(look_ahead_mask(5).numpy(),
                                  np.triu(np.ones((5, 5), bool), 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_levenshtein_matches_jax(seed):
    rng = np.random.RandomState(seed)
    a = list(rng.randint(0, 5, rng.randint(0, 12)))
    b = list(rng.randint(0, 5, rng.randint(0, 12)))
    assert levenshtein(a, b) == jax_levenshtein(a, b)
    assert batch_cer([list("abc"), a], [list("abd"), b]) == (
        1 + jax_levenshtein(b, a), 3 + len(b))


def test_vocab_and_wav_round_trip(tmp_path):
    vocab = Vocabulary.from_symbols(["你", "好", "<unk>"])
    vocab.save(str(tmp_path / "v.txt"))
    back = Vocabulary.from_file(str(tmp_path / "v.txt"))
    assert back.index2word[0] == "<b>" and len(back) == 4
    assert back.encode(["好", "?"]) == [2, 3]
    assert back.decode([1, 2]) == ["你", "好"]
    wave = _wave(1234, seed=3)
    write_wave(str(tmp_path / "a.wav"), wave, rate=16000)
    got, rate = read_wave(str(tmp_path / "a.wav"))
    assert rate == 16000
    np.testing.assert_array_equal(got, wave)
