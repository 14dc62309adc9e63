"""PyTorch port: the on-device log-mel frontend (``ops/features.py``) and
``data.on_device_features`` held against the JAX package and the host
pipeline.

The port's ``extract_batch_padded`` on the CPU matches the JAX function and
the host features (``AudioDataset`` feature mode) within rtol = atol =
2e-3, the JAX package's own tolerance for this path
(``tests/test_on_device_features.py``), with ``t_len`` exact.  An
utterance longer than the wave budget is clipped as audio on one side and
as feature rows on the other, so the rows whose stacked frames reach past
the clipped audio are left out of the host comparison: the last row, as
the JAX test does, and with right context one more.  Raw-wave items equal the JAX
dataset's to the bit; two tiny epochs of the trainer on raw waves match
its host-feature run within 2e-3."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_helpers import make_corpus, tiny_train_config
from transformer_transducer_tpu.data.dataset import AudioDataset as JaxDataset
from transformer_transducer_tpu.ops import features as jax_features
from transformer_transducer_tpu.utils.vocab import Vocabulary as JaxVocabulary
from transformer_transducer_tpu_torch.data.dataset import AudioDataset
from transformer_transducer_tpu_torch.ops import features
from transformer_transducer_tpu_torch.training.trainer import Trainer
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.vocab import Vocabulary

torch.set_num_threads(1)

TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Waves of 3200-16000 samples against a 24-row budget (cap 11040
    samples): both under- and over-length utterances."""
    root = str(tmp_path_factory.mktemp("odf_corpus"))
    vocab_path, csvs = make_corpus(root, n_train=8, n_dev=4, max_len=16000)
    return tiny_train_config(root, vocab_path, csvs, n_enc=2, d_model=64)


def _datasets(cfg, **kw):
    pcfg = Config(cfg.to_dict())
    vocab = Vocabulary.from_file(pcfg.data.vocab)
    host = AudioDataset(pcfg.data, "train", vocab, **kw)
    raw = AudioDataset(pcfg.data, "train", vocab, on_device_features=True, **kw)
    jraw = JaxDataset(cfg.data, "train", JaxVocabulary.from_file(cfg.data.vocab),
                      on_device_features=True, **kw)
    return host, raw, jraw


def _raw_batch(raw):
    items = [raw[i] for i in range(len(raw))]
    return np.stack([it[0] for it in items]), np.array([it[1] for it in items])


@pytest.mark.parametrize("augment", [False, True])
def test_raw_items_are_bit_equal_to_jax(corpus, augment):
    """int16 waves (the augmentation chain keeps the dtype) in the padded
    layout, with the true sample count; augmented items differ from the
    plain ones."""
    _, raw, jraw = _datasets(corpus, augment=augment)
    _, plain, _ = _datasets(corpus)
    raw.loader_epoch = jraw.loader_epoch = 2
    changed = 0
    for i in range(len(raw)):
        for a, b in zip(raw[i], jraw[i]):
            assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b), i
        assert raw[i][0].dtype == np.int16
        changed += not np.array_equal(raw[i][0], plain[i][0])
    assert (changed > 0) == augment


def test_float_waves_ship_as_float32():
    """A float wave (float64 from numpy work) is padded as float32, its
    layout the int16 one's."""
    from transformer_transducer_tpu_torch.data.dataset import pad_raw_wave
    cap, total = features.padded_wave_samples(24, 3)
    wave = np.random.RandomState(0).randn(5000) * 1000
    out, n = pad_raw_wave(wave, cap, total)
    ref, ref_n = pad_raw_wave(wave.astype(np.int16), cap, total)
    assert out.dtype == np.float32 and ref.dtype == np.int16 and n == ref_n == 5000
    np.testing.assert_array_equal(out.astype(np.int16), ref)
    assert not out[256 + 5000 + 256:].any()


@pytest.mark.parametrize("variant", ["eps", "masked"])
@pytest.mark.parametrize("right", [0, 2])
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_extract_batch_padded_matches_jax(corpus, variant, right, dtype):
    cfg = copy.deepcopy(corpus)
    cfg.override("data.right_context_width", right)
    _, raw, _ = _datasets(cfg)
    waves, n = _raw_batch(raw)
    waves = waves.astype(dtype)
    kw = dict(n_mels=16, left=3, right=right, factor=3, log_variant=variant)
    got, t_len = features.extract_batch_padded(torch.from_numpy(waves), torch.from_numpy(n),
                                               24, **kw)
    ref, ref_len = jax_features.extract_batch_padded(jnp.asarray(waves), jnp.asarray(n),
                                                     24, **kw)
    assert torch.equal(t_len, torch.from_numpy(np.array(ref_len)).to(t_len.dtype))
    assert got.shape == ref.shape == (len(waves), 24, 16 * (4 + right))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("right", [0, 2])
def test_extract_batch_padded_matches_host_pipeline(corpus, right):
    cfg = copy.deepcopy(corpus)
    cfg.override("data.right_context_width", right)
    host, raw, _ = _datasets(cfg)
    waves, n = _raw_batch(raw)
    got, t_len = features.extract_batch_padded(torch.from_numpy(waves), torch.from_numpy(n),
                                               24, n_mels=16, left=3, right=right)
    cap, _ = features.padded_wave_samples(24, 3)
    frames = features.raw_frame_count(cap)
    over = 0
    for i in range(len(host)):
        f, tl, _, _ = host[i]
        assert int(t_len[i]) == int(tl)
        end = int(tl)
        if n[i] >= cap:
            # clipped audio: leave out the rows whose stacked frames reach a
            # window past the cap (frames >= frames - 2, 256 samples a side)
            end = min(end, -(-(frames - 2 - right) // 3))
            over += 1
        np.testing.assert_allclose(got[i, :end].numpy(), f[:end], **TOL, err_msg=f"utt {i}")
        assert not got[i, int(tl):].any()
    assert 0 < over < len(host), "both under- and over-length utterances"


@pytest.mark.parametrize("seed", [4, 5])
def test_melspectrogram_and_budgets_match_jax(seed):
    """The power mel spectrogram of host-reflected waves (the JAX
    function's ``center=False``) and the frame and wave budgets."""
    rng = np.random.RandomState(seed)
    waves = (rng.randn(3, 9000) * 2000).astype(np.float32)
    got = features.melspectrogram(torch.from_numpy(waves), n_mels=16)
    ref = np.stack([np.asarray(jax_features.melspectrogram(jnp.asarray(w), n_mels=16,
                                                           center=False)) for w in waves])
    assert got.shape == ref.shape == (3, 1 + (9000 - 512) // 160, 16)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3 * float(ref.max()))
    assert features.raw_frame_count(9000) == jax_features.raw_frame_count(9000) == 57
    assert (features.padded_wave_samples(410, 3)
            == jax_features.padded_wave_samples(410, 3) == (196320, 196832))


def test_extract_batch_padded_rejects_a_wrong_length():
    with pytest.raises(ValueError, match="padded wave length"):
        features.extract_batch_padded(torch.zeros(2, 1000), torch.tensor([5, 6]), 24)


def test_cmvn_with_on_device_features_raises(corpus):
    pcfg = Config(corpus.to_dict())
    with pytest.raises(NotImplementedError, match="CMVN"):
        AudioDataset(pcfg.data, "train", Vocabulary.from_file(pcfg.data.vocab),
                     on_device_features=True, cmvn=object())


def test_trainer_on_device_features_matches_host(corpus, tmp_path):
    """``data.on_device_features``: two epochs (SpecAugment on, the same
    stripes on both sides) give the host-feature run's losses within 2e-3,
    the evaluation featurizes before its encode, and the loaders publish
    raw int16 waves."""
    cfg = Config(corpus.to_dict())
    cfg_dev = Config(corpus.to_dict())
    cfg_dev.override("data.on_device_features", True)
    cfg_dev.override("training.save_model", "tiny_odf")
    t_host = Trainer(cfg, exp_root=str(tmp_path / "host"), device="cpu")
    t_dev = Trainer(cfg_dev, exp_root=str(tmp_path / "dev"), device="cpu")
    assert t_dev.step_cfg.frontend == (16, 3, 0, 3, 24, "eps")
    h_loader, h_eval = t_host.make_loaders()
    d_loader, d_eval = t_dev.make_loaders()
    batch = next(iter(d_eval))
    assert batch["inputs"].dtype == np.int16 and batch["inputs"].shape[1] == 11552
    for epoch in range(2):
        l_h = t_host.train_epoch(epoch, h_loader)
        l_d = t_dev.train_epoch(epoch, d_loader)
        np.testing.assert_allclose(l_d, l_h, **TOL)
    cer_h, cer_d = t_host.evaluate(1, h_eval), t_dev.evaluate(1, d_eval)
    assert np.isfinite(cer_d) and abs(cer_d - cer_h) <= 100.0 * 6


def test_trainer_on_device_features_with_augment(corpus, tmp_path):
    """``fit(augment=True)`` on raw waves: a finite epoch and a checkpoint."""
    cfg = Config(corpus.to_dict())
    cfg.override("data.on_device_features", True)
    trainer = Trainer(cfg, exp_root=str(tmp_path), device="cpu")
    trainer.fit(epochs=1, augment=True, eval_batches=1)
    import os
    assert os.path.exists(os.path.join(trainer.exp_dir, "epoch_0", "model.pt"))
    log = open(os.path.join(trainer.exp_dir, "train.log"), encoding="utf-8").read()
    assert "CER:" in log and "nan" not in log.lower()
