"""PyTorch port: the tone corpus writer (``tools/tone_demo.py``) held
against the repo-root JAX tool: the same waves to the byte, the same CSVs
(up to the corpus root in each path) and vocabulary, and the same configs
for both geometries."""

import csv
import importlib.util
import os

import pytest

from transformer_transducer_tpu_torch.tools import tone_demo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tone_demo", os.path.join(ROOT, "tools", "tone_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    jax_root = str(tmp_path_factory.mktemp("jax"))
    port_root = str(tmp_path_factory.mktemp("port"))
    want = _jax_tool()._write_corpus(jax_root, n_train=8, n_dev=4, seed=3)
    got = tone_demo._write_corpus(port_root, n_train=8, n_dev=4, seed=3)
    return (jax_root, want), (port_root, got)


def _plain(node):
    """A port ``Config`` as nested plain dicts."""
    return {k: _plain(v) if isinstance(v, dict) else v for k, v in node.items()}


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def test_waves_csvs_and_vocabulary_are_bit_equal(corpora):
    (jax_root, (jax_vocab, jax_csvs)), (port_root, (vocab, csvs)) = corpora
    assert open(vocab, "rb").read() == open(jax_vocab, "rb").read()
    assert set(csvs) == set(jax_csvs) == {"train", "dev", "test"}
    n_waves = 0
    for split in csvs:
        got, want = _rows(csvs[split]), _rows(jax_csvs[split])
        assert got[0] == want[0] == ["file_path", "label"]
        assert len(got) == len(want) == (9 if split == "train" else 5)
        for (path, label), (jax_path, jax_label) in zip(got[1:], want[1:]):
            assert label == jax_label and 2 <= len(label) <= 6
            assert os.path.relpath(path, port_root) == os.path.relpath(jax_path, jax_root)
            assert open(path, "rb").read() == open(jax_path, "rb").read()
            n_waves += 1
    assert n_waves == 16


@pytest.mark.parametrize("geometry", ["small", "aishell"])
def test_configs_equal_the_jax_tool(corpora, geometry):
    _, (port_root, (vocab, csvs)) = corpora
    want = _jax_tool()._config(vocab, csvs, geometry=geometry).to_dict()
    assert _plain(tone_demo._config(vocab, csvs, geometry=geometry)) == want
    assert want["model"]["enc"]["d_model"] == (64 if geometry == "small" else 512)


def test_cli_writes_corpus_and_config(tmp_path):
    from transformer_transducer_tpu_torch.utils.config import load_config
    paths = tone_demo.main(["--out", str(tmp_path / "c"), "--n-train", "3", "--n-dev", "2",
                            "--geometry", "small"])
    cfg = load_config(paths["config"])
    assert cfg.data.train == paths["train"] and cfg.model.enc.d_model == 64
    assert len(_rows(paths["dev"])) == 3
