"""PyTorch port: waveform augmentation (``ops/augment.py``) and the
augmented dataset held against the JAX package to the bit.

The module is numpy only and takes an explicit ``np.random.Generator``, so
for the same seed every function's output equals the JAX function's
exactly (``np.array_equal``, dtype included), on int16 and float32 waves.
The dataset seeds each item with ``SeedSequence([seed, index,
loader_epoch])``; the loader publishes ``loader_epoch`` every epoch, so the
draw changes between epochs."""

import numpy as np
import pytest
import torch

from data_helpers import make_corpus, tiny_train_config
from transformer_transducer_tpu.data.dataset import AudioDataset as JaxDataset
from transformer_transducer_tpu.data.loader import DataLoader as JaxLoader
from transformer_transducer_tpu.ops import augment as jax_aug
from transformer_transducer_tpu.utils.vocab import Vocabulary as JaxVocabulary
from transformer_transducer_tpu_torch.data.dataset import AudioDataset
from transformer_transducer_tpu_torch.data.loader import DataLoader
from transformer_transducer_tpu_torch.ops import augment as aug
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.vocab import Vocabulary

torch.set_num_threads(1)


def _wave(dtype, n=12000, seed=0):
    rng = np.random.RandomState(seed)
    tt = np.arange(n) / 16000.0
    x = 3000 * np.sin(2 * np.pi * 220 * tt) + 800 * rng.randn(n)
    return x.astype(dtype)


_RNG_FNS = {
    "gaussian_white_noise": {}, "uniform_white_noise": {},
    "volume_gain": {}, "speed_perturb": {}, "speed_perturb_stft": {},
    "speed_perturb_chunked": {}, "time_shift": {}, "pitch_shift_fft": {},
    "audio_augment": {}, "speed_perturb_slow": {"min_rate": 0.7, "max_rate": 0.8},
    "gaussian_white_noise_loud": {"min_db": 500, "max_db": 900},
}


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("name", sorted(_RNG_FNS))
@pytest.mark.parametrize("seed", [0, 5])
def test_augment_functions_are_bit_equal_to_jax(name, dtype, seed):
    fn = name.replace("_slow", "").replace("_loud", "")
    x = _wave(dtype, seed=seed)
    got = getattr(aug, fn)(np.random.default_rng(seed), x, **_RNG_FNS[name])
    ref = getattr(jax_aug, fn)(np.random.default_rng(seed), x, **_RNG_FNS[name])
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_natural_noise_and_fixed_shift_are_bit_equal(dtype):
    x, noise = _wave(dtype, seed=1), _wave(dtype, n=3000, seed=2)
    got = aug.natural_noise(np.random.default_rng(3), x, noise)
    ref = jax_aug.natural_noise(np.random.default_rng(3), x, noise)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(aug.time_shift_fixed(x, 0.07), jax_aug.time_shift_fixed(x, 0.07))


def test_chain_draws_every_branch_over_seeds():
    """Over 40 seeds the chain takes each gated branch at least once, and
    its output equals the JAX chain's for every seed."""
    x = _wave(np.int16)
    lengths = set()
    changed = 0
    for seed in range(40):
        got = aug.audio_augment(np.random.default_rng(seed), x)
        ref = jax_aug.audio_augment(np.random.default_rng(seed), x)
        assert np.array_equal(got, ref)
        lengths.add(len(got))
        changed += not np.array_equal(got, x)
    assert len(lengths) > 2 and 0 < changed < 40


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("augment_corpus"))
    vocab_path, csvs = make_corpus(root, n_train=8, n_dev=2)
    return tiny_train_config(root, vocab_path, csvs)


@pytest.mark.parametrize("on_device_features", [False, True])
@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 3), (11, 1)])
def test_augmented_items_are_bit_equal_to_jax(corpus, seed, epoch, on_device_features):
    """Host features and raw-wave items of ``AudioDataset(augment=True)``
    equal the JAX dataset's to the bit for the same seed, index and epoch."""
    cfg = Config(corpus.to_dict())
    ds = AudioDataset(cfg.data, "train", Vocabulary.from_file(cfg.data.vocab), augment=True,
                      seed=seed, on_device_features=on_device_features)
    ref = JaxDataset(corpus.data, "train", JaxVocabulary.from_file(corpus.data.vocab),
                     augment=True, seed=seed, on_device_features=on_device_features)
    ds.loader_epoch = ref.loader_epoch = epoch
    for i in range(len(ds)):
        for a, b in zip(ds[i], ref[i]):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.array_equal(a, b), i


def test_augmentation_changes_between_epochs_through_the_loader(corpus):
    """The loader publishes its epoch to the dataset: two epochs of the same
    batch order draw different augmentations, and each epoch's batches
    equal the JAX loader's."""
    cfg = Config(corpus.to_dict())
    ds = AudioDataset(cfg.data, "train", Vocabulary.from_file(cfg.data.vocab), augment=True)
    ref = JaxDataset(corpus.data, "train", JaxVocabulary.from_file(corpus.data.vocab),
                     augment=True)
    loader = DataLoader(ds, 4, shuffle=False, num_workers=2)
    jloader = JaxLoader(ref, 4, shuffle=False, num_workers=2)
    epochs = []
    for _ in range(2):
        batches = list(loader)
        for got, want in zip(batches, jloader):
            for key in want:
                assert np.array_equal(got[key], want[key]), key
        epochs.append(batches)
    assert ds.loader_epoch == ref.loader_epoch == 2
    assert any(not np.array_equal(a["inputs"], b["inputs"])
               for a, b in zip(*epochs)), "augmentation repeated across epochs"
    plain = AudioDataset(cfg.data, "train", Vocabulary.from_file(cfg.data.vocab))
    first = np.stack([plain[i][0] for i in range(4)])
    assert not np.array_equal(epochs[0][0]["inputs"], first)
