"""PyTorch port: the trainer and its CLI on the CPU, on a synthetic tone
corpus with a tiny config: epochs with checkpoints, decode dumps and CER,
``-mode continue``, the exact mid-epoch resume of ``--save-steps``, a
falling loss, checkpoint loading (also by ``apps/predict.py``), the pruned
loss (``--pruned-range``), and the flags of later slices (tensor, pipeline
and sequence parallelism)."""

import glob
import os

import numpy as np
import pytest

import torch

from data_helpers import make_tone_corpus, tiny_train_config
from transformer_transducer_tpu_torch.apps import predict as predict_app
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


@pytest.fixture(scope="module")
def one_epoch(corpus, tmp_path_factory):
    """The CLI trained one epoch: (trainer, its config file, its epoch_0)."""
    root = tmp_path_factory.mktemp("one_epoch")
    path = str(root / "tiny.yaml")
    dump_config(_cfg(corpus), path)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        trainer = train_app.main(["-config", path, "--device", "cpu", "--epochs", "1"])
    finally:
        os.chdir(cwd)
    return trainer, path, str(root / trainer.exp_dir / "epoch_0")


@pytest.mark.parametrize("form", ["epoch directory", "model.pt", "flat state_dict"])
def test_predict_loads_what_training_wrote(corpus, one_epoch, tmp_path, form):
    """``apps/predict.py`` takes the trainer's ``epoch_0`` directory, its
    ``model.pt`` and a flat ``state_dict`` file: the weights are the
    trainer's and the tokens its model's greedy decode."""
    from transformer_transducer_tpu_torch.data.wav import read_wave
    from transformer_transducer_tpu_torch.decoding.greedy import recognize
    from transformer_transducer_tpu_torch.models.factory import load_family
    from transformer_transducer_tpu_torch.ops import features_np as F
    from transformer_transducer_tpu_torch.utils.config import (
        stack_context, subsample_factor)
    from transformer_transducer_tpu_torch.utils.vocab import Vocabulary
    trainer, cfg_path, ckpt = one_epoch
    if form == "model.pt":
        ckpt = os.path.join(ckpt, ckpt_lib.MODEL_FILE)
    elif form == "flat state_dict":
        ckpt = str(tmp_path / "flat.pt")
        torch.save(trainer.model.state_dict(), ckpt)
    cfg = load_config(cfg_path)
    left, right = stack_context(cfg.data)
    d_in = cfg.data.feature_dim * (1 + left + right)
    loaded = load_family(cfg, d_in, ckpt, device="cpu")
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            loaded.state_dict().values()):
        assert torch.equal(a, b), name

    wav = open(corpus[2]["dev"], encoding="utf-8").read().splitlines()[1].split(",")[0]
    text = predict_app.main(["--config", cfg_path, "--checkpoint", ckpt, "--wav", wav,
                             "--device", "cpu"])
    wave, rate = read_wave(wav)
    feats = F.subsample(F.stack_frames(F.logmel_masked(wave, rate, cfg.data.feature_dim),
                                       left, right), subsample_factor(cfg.data))
    trainer.model.eval()
    tokens = recognize(trainer.model, torch.from_numpy(feats[None]), [feats.shape[0]],
                       band=(cfg.model.enc.left_context, cfg.model.enc.right_context),
                       max_tokens=cfg.data.max_target_length + 1)[0]
    assert text == "".join(Vocabulary.from_file(cfg.data.vocab).decode(tokens))


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
    # --bf16, --remat and --bf16 --flash train now
    # (tests/test_torch_port_bf16_training.py), --profile profiles
    # (tests/test_torch_port_profile.py), and --n_data and --zero train
    # (tests/test_torch_port_parallel.py), and so do --n_model
    # (tests/test_torch_port_tensor_parallel.py) and --n_pipe / --pipe-micro
    # (tests/test_torch_port_pipeline.py): beside them --n_seq still raises
    ["--n_data", "2", "--n_seq", "2"], ["--n_pipe", "2", "--n_seq", "2"],
    ["--pipe-micro", "2", "--n_seq", "2"], ["--n_seq", "2"]])
def test_flags_of_later_slices_raise(flag):
    with pytest.raises(NotImplementedError, match="later slice"):
        train_app.main(["--device", "cpu", *flag])


@pytest.mark.parametrize("key,value", [("parallel.n_pipe", 2), ("parallel.n_seq", 2)])
def test_trainer_raises_for_later_slices(corpus, tmp_path, key, value):
    # parallel.n_pipe trains (tests/test_torch_port_pipeline.py); beside it
    # and alone, parallel.n_seq still raises
    with pytest.raises(NotImplementedError, match="later slice"):
        Trainer(_cfg(corpus, **{key: value, "parallel.n_seq": 2}), exp_root=str(tmp_path),
                device="cpu")


def test_cli_trains_the_pruned_loss(corpus, tmp_path, monkeypatch):
    """``--pruned-range 3`` trains the tone corpus and writes checkpoints;
    the step config carries the band and the default simple scale, and the
    evaluation reports the full NLL."""
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "tiny.yaml")
    dump_config(_cfg(corpus), path)
    trainer = train_app.main(["-config", path, "--device", "cpu", "--banded",
                              "--pruned-range", "3", "--epochs", "1"])
    assert trainer.step_cfg.loss_pruned_range == 3
    assert trainer.step_cfg.loss_simple_scale == 0.25
    assert trainer.config.training.loss_pruned_range == 3
    assert trainer.global_step == 3
    assert os.path.exists(os.path.join(trainer.exp_dir, "epoch_0", "model.pt"))
    log = open(os.path.join(trainer.exp_dir, "train.log"), encoding="utf-8").read()
    assert log.count("CER:") == 1 and "nan" not in log.lower()
    _, dev = trainer.make_loaders()
    batch = next(iter(dev))
    from transformer_transducer_tpu_torch.training.train_step import (
        TrainStepConfig, batch_to_device, make_eval_loss_step)
    full = make_eval_loss_step(trainer.model, TrainStepConfig())(
        batch_to_device(batch, "cpu"))
    assert torch.equal(trainer.eval_loss_step(batch_to_device(batch, "cpu")), full)


@pytest.mark.parametrize("overrides,want", [
    ({}, (None, 0.25)),
    ({"training.loss_pruned_range": 4}, (4, 0.25)),
    ({"training.loss_pruned_range": 2, "training.loss_simple_scale": 0.0}, (2, 0.0))])
def test_trainer_wires_the_pruned_loss_config(corpus, tmp_path, overrides, want):
    trainer = Trainer(_cfg(corpus, **overrides), exp_root=str(tmp_path), device="cpu")
    assert (trainer.step_cfg.loss_pruned_range, trainer.step_cfg.loss_simple_scale) == want


def test_pruned_memorisation_loss_falls(corpus, tmp_path):
    cfg = _cfg(corpus, **{"training.specaug": False, "optim.type": "adam",
                          "optim.lr": 2e-3, "optim.decay_ratio": 1.0,
                          "training.loss_pruned_range": 2})
    trainer = Trainer(cfg, exp_root=str(tmp_path), device="cpu")
    loader, _ = trainer.make_loaders()
    losses = [trainer.train_epoch(epoch, loader) for epoch in range(8)]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.6 * losses[0], losses
