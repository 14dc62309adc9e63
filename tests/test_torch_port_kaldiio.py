"""PyTorch port: kaldi matrix I/O (``data/kaldiio.py``) and per-speaker
CMVN (``data/dataset.py::CMVN``) held against the JAX package.

What the JAX package writes the port reads, and the other way round, in
every format: binary float and double matrices and vectors, text, the
compressed ``CM`` form, arks and scp files with offsets.  Reads are
exact (``np.array_equal``, dtype included) because both sides decode the
same bytes with the same numpy code; written files are byte-identical.
``cmvn_stats`` and the CMVN dataset items equal the JAX ones exactly."""

import struct

import numpy as np
import pytest
import torch

from data_helpers import make_corpus, tiny_train_config
from transformer_transducer_tpu.data import kaldiio as jax_kaldiio
from transformer_transducer_tpu.data.dataset import AudioDataset as JaxDataset
from transformer_transducer_tpu.data.dataset import CMVN as JaxCMVN
from transformer_transducer_tpu.utils.vocab import Vocabulary as JaxVocabulary
from transformer_transducer_tpu_torch.data import kaldiio
from transformer_transducer_tpu_torch.data.dataset import CMVN, AudioDataset, read_manifest
from transformer_transducer_tpu_torch.data.wav import read_wave
from transformer_transducer_tpu_torch.ops import features_np as F
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.vocab import Vocabulary

torch.set_num_threads(1)

WRITERS = {"port": kaldiio, "jax": jax_kaldiio}


def _mats(dtype, seed=0):
    rng = np.random.RandomState(seed)
    return {f"utt{i}": (rng.randn(3 + 5 * i, 7) * 3 + 1).astype(dtype) for i in range(3)}


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_binary_matrices_both_ways(tmp_path, writer, reader, dtype):
    w, r = WRITERS[writer], WRITERS[reader]
    m = _mats(dtype)["utt2"]
    path = str(tmp_path / "m.mat")
    assert w.write_mat(path, m) == 0
    _same(r.read_mat(path), m)
    _same(kaldiio.read_mat(path), jax_kaldiio.read_mat(path))
    other = str(tmp_path / "o.mat")
    WRITERS["jax" if writer == "port" else "port"].write_mat(other, m)
    assert open(path, "rb").read() == open(other, "rb").read()


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_arks_and_scps_both_ways(tmp_path, writer, reader, dtype):
    mats = _mats(dtype, seed=1)
    ark, scp = str(tmp_path / "f.ark"), str(tmp_path / "f.scp")
    WRITERS[writer].write_ark_scp(ark, scp, mats)
    r = WRITERS[reader]
    via_scp, via_ark = dict(r.read_mat_scp(scp)), dict(r.read_mat_ark(ark))
    assert list(via_scp) == list(via_ark) == list(mats)
    for key, m in mats.items():
        _same(via_scp[key], m)
        _same(via_ark[key], m)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("rows", [1, 4, 64])
def test_compressed_matrices_both_ways(tmp_path, writer, reader, rows):
    """The lossy ``CM`` form: both writers give the same bytes, both readers
    the same matrix, within the quantization step of the original."""
    rng = np.random.RandomState(rows)
    m = (rng.randn(rows, 13) * 4.0 + 1.5).astype(np.float32)
    ark = str(tmp_path / "c.ark")
    with open(ark, "wb") as fh:
        fh.write(b"spk1 ")
        off = WRITERS[writer].write_mat_compressed(fh, m)
    got = WRITERS[reader].read_mat(f"{ark}:{off}")
    _same(got, jax_kaldiio.read_mat(f"{ark}:{off}"))
    _same(kaldiio.read_mat(f"{ark}:{off}"), got)
    assert np.abs(got - m).max() <= float(m.max() - m.min()) / 63.0 + 1e-4
    (key, via_ark), = list(WRITERS[reader].read_mat_ark(ark))
    assert key == "spk1"
    _same(via_ark, got)
    other = str(tmp_path / "c.mat")
    WRITERS["jax" if writer == "port" else "port"].write_mat_compressed(other, m, key="spk1")
    assert open(ark, "rb").read() == open(other, "rb").read()


@pytest.mark.parametrize("token,dtype", [(b"FV ", "<f4"), (b"DV ", "<f8")])
def test_binary_vectors(tmp_path, token, dtype):
    v = np.linspace(-2, 5, 11).astype(dtype)
    path = tmp_path / "v.vec"
    path.write_bytes(b"\x00B" + token + b"\x04" + struct.pack("<i", len(v)) + v.tobytes())
    _same(kaldiio.read_mat(str(path)), jax_kaldiio.read_mat(str(path)))
    _same(kaldiio.read_mat(str(path)), v)


def test_text_matrices_and_errors(tmp_path):
    path = tmp_path / "t.mat"
    path.write_text(" [\n 1.0 2.0\n 3.0 4.5 ]\n")
    _same(kaldiio.read_mat(str(path)), jax_kaldiio.read_mat(str(path)))
    with open(path, "rb") as fh:
        _same(kaldiio.read_mat(fh), np.array([[1.0, 2.0], [3.0, 4.5]], np.float32))
    path.write_bytes(b"\x00BCM2 " + b"\x00" * 16)
    with pytest.raises(ValueError, match="CM2"):
        kaldiio.read_mat(str(path))
    path.write_bytes(b"\x00BXM ")
    with pytest.raises(ValueError, match="XM"):
        kaldiio.read_mat(str(path))
    path.write_bytes(b"\x00BFM \x08")
    with pytest.raises(ValueError, match="int32 size byte"):
        kaldiio.read_mat(str(path))
    path.write_text("1 2 3\n")
    with pytest.raises(ValueError, match="not a kaldi matrix"):
        kaldiio.read_mat(str(path))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cmvn_stats_match(seed):
    feats = _mats(np.float32, seed)["utt2"]
    _same(kaldiio.cmvn_stats(feats), jax_kaldiio.cmvn_stats(feats))
    stats = kaldiio.cmvn_stats(feats)
    out = CMVN({"u": "s"}, {"s": stats})("u", feats)
    _same(out, JaxCMVN({"u": "s"}, {"s": stats})("u", feats))
    np.testing.assert_allclose(out.mean(axis=0), 0.0, atol=1e-5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cmvn_corpus")
    vocab_path, csvs = make_corpus(str(root), n_train=6, n_dev=2)
    return root, tiny_train_config(str(root), vocab_path, csvs)


def test_cmvn_items_equal_jax(corpus):
    """Per-speaker stats written to an ark by the port, read back through
    the scp by both packages: the CMVN dataset items (normalized log-mel,
    keyed by the row's path, then stacked and subsampled) equal the JAX
    dataset's exactly, and differ from the plain items."""
    root, cfg = corpus
    rows = read_manifest(cfg.data.train)
    utt2spk = {path: f"spk{i % 2}" for i, (path, _) in enumerate(rows)}
    per_spk = {}
    for path, _ in rows:
        wave, rate = read_wave(path)
        per_spk.setdefault(utt2spk[path], []).append(F.logmel_eps(wave, rate, 4))
    stats = {spk: kaldiio.cmvn_stats(np.concatenate(m)) for spk, m in per_spk.items()}
    ark, scp = str(root / "cmvn.ark"), str(root / "cmvn.scp")
    kaldiio.write_ark_scp(ark, scp, stats)
    port_stats, jax_stats = dict(kaldiio.read_mat_scp(scp)), dict(jax_kaldiio.read_mat_scp(scp))
    pcfg = Config(cfg.to_dict())
    ds = AudioDataset(pcfg.data, "train", Vocabulary.from_file(pcfg.data.vocab),
                      cmvn=CMVN(utt2spk, port_stats))
    ref = JaxDataset(cfg.data, "train", JaxVocabulary.from_file(cfg.data.vocab),
                     cmvn=JaxCMVN(utt2spk, jax_stats))
    plain = AudioDataset(pcfg.data, "train", Vocabulary.from_file(pcfg.data.vocab))
    for i in range(len(ds)):
        for a, b in zip(ds[i], ref[i]):
            _same(np.asarray(a), np.asarray(b))
        assert not np.array_equal(ds[i][0], plain[i][0])
