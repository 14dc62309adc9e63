"""PyTorch port: the profiled epoch (``Trainer.profile_epoch``, ``fit(
profile_dir=...)``, ``apps/train.py --profile DIR``) on the CPU with a tiny
trainer (2 encoder layers, d_model 64): the first epoch of the run, and
only it, runs under ``torch.profiler`` and leaves one parsable TensorBoard
``*.pt.trace.json``; profiling changes no weight; a training failure inside
the profiled epoch propagates, while a profiler that cannot start or finish
logs a warning and the epoch stands, the JAX package's contract
(``training/trainer.py:668-693``).  The evaluation's CER, now on token
ids through the native edit distance, equals the CER of its decode dump's
text."""

import glob
import json
import logging
import os

import pytest
import torch

from data_helpers import make_tone_corpus, tiny_train_config
from transformer_transducer_tpu_torch.apps import train as train_app
from transformer_transducer_tpu_torch.training.trainer import Trainer
from transformer_transducer_tpu_torch.utils.config import Config, dump_config
from transformer_transducer_tpu_torch.utils.metrics import batch_cer_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tones"))
    vocab_path, csvs = make_tone_corpus(root, n_train=8, n_dev=4)
    return root, vocab_path, csvs


def _cfg(corpus) -> Config:
    return Config(tiny_train_config(*corpus, n_enc=2, d_model=64).to_dict())


def _traces(trace_dir):
    return sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json")))


def _profiled_steps(trainer):
    """Wrap the trainer's step to record, per call, whether the profiler
    was recording."""
    seen = []
    step = trainer.train_step

    def wrapped(batch, gen):
        seen.append(torch.autograd.profiler._is_profiler_enabled)
        return step(batch, gen)

    trainer.train_step = wrapped
    return seen


def test_fit_profiles_the_first_epoch_only(corpus, tmp_path):
    trace_dir = str(tmp_path / "trace")
    trainer = Trainer(_cfg(corpus), exp_root=str(tmp_path / "a"), device="cpu")
    seen = _profiled_steps(trainer)
    trainer.fit(epochs=2, profile_dir=trace_dir)
    assert seen == [True, True, False, False]       # 8 utterances, batch 4
    (path,) = _traces(trace_dir)
    with open(path) as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert "aten::linear" in names and any("backward" in n.lower() for n in names)
    # the same run unprofiled: the same weights to the bit
    plain = Trainer(_cfg(corpus), exp_root=str(tmp_path / "b"), device="cpu")
    plain.fit(epochs=2)
    for a, b in zip(trainer.model.state_dict().values(), plain.model.state_dict().values()):
        assert torch.equal(a, b)
    # the CER on ids equals the CER of the decoded text in the dump
    log = open(os.path.join(trainer.exp_dir, "train.log"), encoding="utf-8").read()
    logged = float(log.rsplit("CER: ", 1)[1].split()[0])
    with open(os.path.join(trainer.exp_dir, "decode_1.txt"), encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    refs = [list(s[len("Transcripts:"):]) for s in lines[0::2]]
    preds = [list(s[len("---Predicts:"):]) for s in lines[1::2]]
    dist, total = batch_cer_numpy(preds, refs)
    assert logged == pytest.approx(100.0 * dist / total, abs=1e-5)


def test_cli_profile_flag_writes_a_trace(corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg_path = str(tmp_path / "tiny.yaml")
    dump_config(_cfg(corpus), cfg_path)
    trainer = train_app.main(["-config", cfg_path, "--device", "cpu", "--epochs", "1",
                              "--profile", "trace"])
    assert trainer.global_step == 2
    (path,) = _traces(str(tmp_path / "trace"))
    with open(path) as fh:
        assert json.load(fh)["traceEvents"]
    log = open(os.path.join(trainer.exp_dir, "train.log"), encoding="utf-8").read()
    assert "profiler trace written to trace" in log


def test_a_training_failure_in_the_profiled_epoch_propagates(corpus, tmp_path, caplog):
    trainer = Trainer(_cfg(corpus), exp_root=str(tmp_path), device="cpu")
    calls = []

    def failing(batch, gen):
        calls.append(1)
        raise FloatingPointError("the step failed")

    trainer.train_step = failing
    with caplog.at_level(logging.WARNING):
        with pytest.raises(FloatingPointError, match="the step failed"):
            trainer.fit(epochs=2, profile_dir=str(tmp_path / "trace"))
    assert calls == [1]
    assert not torch.autograd.profiler._is_profiler_enabled
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
    assert not os.path.exists(os.path.join(trainer.exp_dir, "epoch_0"))


@pytest.mark.parametrize("where", ["start", "finish"])
def test_a_profiler_failure_warns_and_the_epoch_stands(corpus, tmp_path, monkeypatch, where):
    real = torch.profiler.profile

    class Broken(real):
        def __init__(self, *args, **kwargs):
            if where == "start":
                raise RuntimeError("no profiler on this build")
            super().__init__(*args, **kwargs)

        def __exit__(self, *exc):
            super().__exit__(*exc)
            raise RuntimeError("the trace could not be written")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    trainer = Trainer(_cfg(corpus), exp_root=str(tmp_path / "exp"), device="cpu")
    seen = _profiled_steps(trainer)
    loader, _ = trainer.make_loaders()
    avg = trainer.profile_epoch(0, loader, str(tmp_path / "trace"))
    assert avg > 0 and trainer.global_step == 2 and len(seen) == 2
    assert seen == [where == "finish"] * 2
    log = open(os.path.join(trainer.exp_dir, "train.log"), encoding="utf-8").read()
    want = {"start": "profiler unavailable (no profiler on this build); training unprofiled",
            "finish": "profiler teardown failed (the trace could not be written)"}[where]
    assert want in log
