"""PyTorch port: the trainer and its CLI on the CPU, on a synthetic tone
corpus with a tiny config: epochs with checkpoints, decode dumps and CER,
``-mode continue``, the exact mid-epoch resume of ``--save-steps``, a
falling loss, checkpoint loading, and the flags of later slices."""

import glob
import os

import numpy as np
import pytest

import torch

from data_helpers import make_tone_corpus, tiny_train_config
from transformer_transducer_tpu_torch.apps import train as train_app
from transformer_transducer_tpu_torch.training.trainer import Trainer
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.config import Config, dump_config, load_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tones"))
    vocab_path, csvs = make_tone_corpus(root, n_train=12, n_dev=4)
    return root, vocab_path, csvs


def _cfg(corpus, **overrides) -> Config:
    cfg = Config(tiny_train_config(*corpus).to_dict())
    for key, value in overrides.items():
        cfg.override(key, value)
    return cfg


class _TruncatedLoader:
    """A loader that stops after ``n`` batches (a process that dies)."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __setattr__(self, name, value):
        if name in ("loader", "n"):
            object.__setattr__(self, name, value)
        else:
            setattr(self.loader, name, value)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i >= self.n:
                break
            yield batch


def test_cli_trains_epochs_then_continues(corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "tiny.yaml")
    dump_config(_cfg(corpus), path)
    assert load_config(path) == _cfg(corpus)
    first = train_app.main(["-config", path, "--device", "cpu", "--flash"])
    exp = first.exp_dir
    assert first.global_step == 6          # 2 epochs of 12 // 4 batches
    for epoch in (0, 1):
        assert os.path.exists(os.path.join(exp, f"epoch_{epoch}", "model.pt"))
        assert os.path.getsize(os.path.join(exp, f"decode_{epoch}.txt")) > 0
    log = open(os.path.join(exp, "train.log"), encoding="utf-8").read()
    assert log.count("CER:") == 2
    state = ckpt_lib.load_checkpoint(os.path.join(exp, "epoch_1"))
    assert {"encoder", "decoder", "joint", "optimizer", "epoch", "step",
            "lr"} <= set(state)
    assert (state["epoch"], state["step"]) == (1, 6)
    assert state["lr"] == pytest.approx(0.01 * 0.5 ** 2)    # decayed twice

    again = train_app.main(["-config", path, "--device", "cpu", "--flash",
                            "-mode", "continue", "--epochs", "3"])
    assert again.start_epoch == 2 and again.global_step == 9
    assert again.optimizer.learning_rate == pytest.approx(0.01 * 0.5 ** 3)
    assert os.path.exists(os.path.join(exp, "epoch_2", "model.pt"))
    assert ckpt_lib.latest_checkpoint(exp).endswith("epoch_2")


def test_save_steps_resume_is_step_for_step(corpus, tmp_path):
    """Stop after batch 1 of epoch 0, resume from the step_* checkpoint: the
    parameters after 2 epochs equal the uninterrupted run's exactly (data
    order, SpecAugment stream and counters restored)."""
    ref = Trainer(_cfg(corpus), exp_root=str(tmp_path / "ref"), device="cpu")
    loader, _ = ref.make_loaders()
    for epoch in range(2):
        ref.train_epoch(epoch, loader)
        ref.save(epoch)

    exp_root = str(tmp_path / "stopped")
    cfg = _cfg(corpus, **{"training.save_every_steps": 1})
    stopped = Trainer(cfg, exp_root=exp_root, device="cpu")
    loader, _ = stopped.make_loaders()
    stopped.train_epoch(0, _TruncatedLoader(loader, 1))
    steps = glob.glob(os.path.join(stopped.exp_dir, "step_*"))
    assert len(steps) == 1 and ckpt_lib.latest_checkpoint(stopped.exp_dir) == steps[0]
    del stopped

    resumed = Trainer(_cfg(corpus), mode="continue", exp_root=exp_root, device="cpu")
    assert (resumed.start_epoch, resumed._resume_batches) == (0, 1)
    loader, _ = resumed.make_loaders()
    for epoch in range(resumed.start_epoch, 2):
        resumed.train_epoch(epoch, loader)
        resumed.save(epoch)
    assert resumed.global_step == ref.global_step
    for a, b in zip(ref.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    assert not glob.glob(os.path.join(resumed.exp_dir, "step_*"))


def test_memorisation_loss_falls(corpus, tmp_path):
    cfg = _cfg(corpus, **{"training.specaug": False, "optim.type": "adam",
                          "optim.lr": 2e-3, "optim.decay_ratio": 1.0})
    trainer = Trainer(cfg, exp_root=str(tmp_path), device="cpu")
    loader, dev = trainer.make_loaders()
    losses = [trainer.train_epoch(epoch, loader) for epoch in range(12)]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], losses
    assert 0.0 <= trainer.evaluate(11, dev) <= 100.0 * 6


def test_load_model_and_components(corpus, tmp_path):
    src = Trainer(_cfg(corpus), exp_root=str(tmp_path / "a"), device="cpu")
    loader, _ = src.make_loaders()
    src.train_epoch(0, loader)
    src.save(0)
    path = os.path.join(src.exp_dir, "epoch_0")
    whole = Trainer(_cfg(corpus, **{"training.load_model": path}),
                    exp_root=str(tmp_path / "b"), device="cpu")
    for a, b in zip(src.model.parameters(), whole.model.parameters()):
        assert torch.equal(a, b)
    part = Trainer(_cfg(corpus, **{"training.load_encoder": path}),
                   exp_root=str(tmp_path / "c"), device="cpu")
    for a, b in zip(src.model.encoder.parameters(), part.model.encoder.parameters()):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in
                   zip(src.model.joint.parameters(), part.model.joint.parameters()))


@pytest.mark.parametrize("flag", [
    ["--bf16"], ["--remat"], ["--augment"], ["--zero"], ["--pruned-range", "4"],
    ["--n_model", "2"], ["--n_data", "2"], ["--n_pipe", "2"],
    ["--pipe-micro", "2"], ["--n_seq", "2"], ["--profile", "trace"]])
def test_flags_of_later_slices_raise(flag):
    with pytest.raises(NotImplementedError, match="later slice"):
        train_app.main(["--device", "cpu", *flag])


@pytest.mark.parametrize("key,value", [("parallel.n_pipe", 2),
                                       ("training.loss_pruned_range", 4),
                                       ("model.mask", {"encoder_left_mask": 4})])
def test_trainer_raises_for_later_slices(corpus, tmp_path, key, value):
    with pytest.raises(NotImplementedError, match="later slice"):
        Trainer(_cfg(corpus, **{key: value}), exp_root=str(tmp_path), device="cpu")
