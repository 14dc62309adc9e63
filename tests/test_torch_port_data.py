"""PyTorch port: the data path (manifest, dataset items, loader order) held
against the JAX package on a synthetic corpus, and SpecAugment's stripe
contract."""

import numpy as np
import pytest

import torch

from data_helpers import make_corpus, tiny_train_config
from transformer_transducer_tpu.data.dataset import AudioDataset as JaxDataset
from transformer_transducer_tpu.data.loader import DataLoader as JaxLoader
from transformer_transducer_tpu.utils.vocab import Vocabulary as JaxVocabulary
from transformer_transducer_tpu_torch.data.dataset import AudioDataset, read_manifest
from transformer_transducer_tpu_torch.data.loader import DataLoader
from transformer_transducer_tpu_torch.ops.specaug import (
    spec_augment, spec_augment_per_utterance)
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.vocab import Vocabulary

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_data"))
    vocab_path, csvs = make_corpus(root, n_train=10, n_dev=3)
    jax_cfg = tiny_train_config(root, vocab_path, csvs)
    return jax_cfg, Config(jax_cfg.to_dict())


@pytest.mark.parametrize("short_first", [False, True])
def test_dataset_items_match_jax(corpus, short_first):
    jax_cfg, cfg = corpus
    jax_cfg.data["short_first"] = cfg.data["short_first"] = short_first
    want = JaxDataset(jax_cfg.data, "train", JaxVocabulary.from_file(jax_cfg.data.vocab))
    got = AudioDataset(cfg.data, "train", Vocabulary.from_file(cfg.data.vocab))
    assert got.rows == want.rows and len(got) == len(want) == 10
    for i in range(len(got)):
        for a, b in zip(got[i], want[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle,drop_last,start", [
    (True, True, 0), (True, True, 1), (False, False, 0), (True, False, 2)])
def test_loader_batch_order_matches_jax(corpus, shuffle, drop_last, start):
    jax_cfg, cfg = corpus
    ds = AudioDataset(cfg.data, "train", Vocabulary.from_file(cfg.data.vocab))
    jds = JaxDataset(jax_cfg.data, "train", JaxVocabulary.from_file(jax_cfg.data.vocab))
    for epoch in (0, 3):
        ours = DataLoader(ds, 4, shuffle=shuffle, seed=7, drop_last=drop_last,
                          num_workers=2)
        theirs = JaxLoader(jds, 4, shuffle=shuffle, seed=7, drop_last=drop_last,
                           num_workers=2)
        for loader in (ours, theirs):
            loader.epoch, loader.start_batch = epoch, start
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours) - start
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


def test_loader_surfaces_worker_errors():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError("unreadable wav")

    with pytest.raises(RuntimeError, match="unreadable wav"):
        list(DataLoader(Broken(), 2, num_workers=1))


def test_read_manifest_keeps_a_headerless_first_row(tmp_path):
    path = tmp_path / "m.csv"
    path.write_text("a.wav,ab\nb.wav,c\n", encoding="utf-8")
    assert read_manifest(str(path)) == [("a.wav", "ab"), ("b.wav", "c")]


def test_later_slices_raise(corpus):
    _, cfg = corpus
    vocab = Vocabulary.from_file(cfg.data.vocab)
    for kw in ({"augment": True}, {"on_device_features": True}, {"cmvn": object()}):
        with pytest.raises(NotImplementedError, match="later slice"):
            AudioDataset(cfg.data, "train", vocab, **kw)


def test_spec_augment_stripes_are_shared_and_bounded():
    """One stripe set for the whole batch, frequency then time; widths in
    [0, max) and at most ``mask_num`` stripes on each axis."""
    x = torch.ones(3, 60, 40)
    for seed in range(20):
        out = spec_augment(torch.Generator().manual_seed(seed), x, 5, 5, 10)
        zero = out == 0
        assert torch.equal(zero, zero[:1].expand_as(zero))     # shared
        freq = zero[0].all(dim=0)          # frequency stripes span all frames
        time = zero[0].all(dim=1)
        assert torch.equal(zero[0], freq[None, :] | time[:, None])
        for mask in (freq, time):
            runs = _runs(mask)
            assert len(runs) <= 10 and all(r <= 4 * 10 for r in runs)
    # a draw with one stripe of each kind has widths below the maximum
    widths = set()
    for seed in range(50):
        out = spec_augment(torch.Generator().manual_seed(seed), x, 5, 5, 1)
        widths.update(_runs((out[0] == 0).all(dim=0)))
        widths.update(_runs((out[0] == 0).all(dim=1)))
    assert widths and max(widths) <= 4
    same = spec_augment(torch.Generator().manual_seed(3), x)
    assert torch.equal(same, spec_augment(torch.Generator().manual_seed(3), x))


def test_spec_augment_per_utterance_draws_each_row():
    x = torch.ones(4, 80, 40)
    out = spec_augment_per_utterance(torch.Generator().manual_seed(0), x)
    rows = [(out[i] == 0) for i in range(4)]
    assert any(not torch.equal(rows[0], r) for r in rows[1:])


def _runs(mask):
    """Lengths of the runs of True in a 1-D mask."""
    runs, n = [], 0
    for v in mask.tolist() + [False]:
        if v:
            n += 1
        elif n:
            runs.append(n)
            n = 0
    return runs
