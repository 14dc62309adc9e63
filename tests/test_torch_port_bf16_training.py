"""PyTorch port: training with ``--bf16`` and ``--remat`` through the
trainer and its CLIs on the CPU (tone corpus, tiny configs): a ``retrain``
epoch for each flag set (dense, ``--banded``, ``--pruned-range``,
``--flash``, the espnet family through ``apps/train_esptt.py``), float32
checkpoints and ``-mode continue`` from
a bf16 run, a JAX bf16 run's checkpoint continued under the port's
``--bf16`` (its first step's loss as JAX's loss function gives it), and
the port's mirror of the JAX package's depth-18 stability smoke
(``tests/test_deep_stability.py::test_depth18_bf16_remat_dropout_stability_smoke``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_helpers import make_tone_corpus, tiny_train_config
from transformer_transducer_tpu.parallel import mesh as mesh_lib
from transformer_transducer_tpu.training.train_step import make_loss_fn as jax_make_loss_fn
from transformer_transducer_tpu.training.trainer import Trainer as JaxTrainer
from transformer_transducer_tpu_torch.apps import train as train_app
from transformer_transducer_tpu_torch.apps import train_esptt
from transformer_transducer_tpu_torch.training.train_step import batch_to_device
from transformer_transducer_tpu_torch.training.trainer import Trainer
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.config import Config, dump_config
from transformer_transducer_tpu_torch.utils.convert import from_jax_params

from torch_port_helpers import espnet_train_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tones"))
    vocab_path, csvs = make_tone_corpus(root, n_train=8, n_dev=4)
    return root, vocab_path, csvs


def _cfg(corpus, **overrides) -> Config:
    cfg = Config(tiny_train_config(*corpus).to_dict())
    for key, value in overrides.items():
        cfg.override(key, value)
    return cfg


def _log(trainer) -> str:
    return open(os.path.join(trainer.exp_dir, "train.log"), encoding="utf-8").read()


@pytest.mark.parametrize("flags", [
    ["--bf16"], ["--remat"], ["--bf16", "--remat", "--nan-guard", "--steps-per-call", "2"],
    ["--bf16", "--remat", "--banded"], ["--bf16", "--banded", "--pruned-range", "3"],
    ["--bf16", "--flash"], ["--bf16", "--remat", "--flash"]])
def test_cli_runs_a_retrain_epoch(corpus, tmp_path, monkeypatch, flags):
    """One epoch: finite losses, the epoch checkpoint, the evaluation's CER,
    the compute dtype and remat in the log, float32 parameters."""
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "tiny.yaml")
    dump_config(_cfg(corpus), path)
    trainer = train_app.main(["-config", path, "--device", "cpu", "--epochs", "1", *flags])
    bf16, remat = "--bf16" in flags, "--remat" in flags
    assert trainer.model.compute_dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert trainer.model.encoder.remat is remat
    assert trainer.model.joint.compute_dtype == trainer.model.compute_dtype
    assert trainer.global_step == 2 and trainer.total_skips == 0
    log = _log(trainer)
    assert log.count("CER:") == 1 and "nan" not in log.lower()
    assert (f"compute dtype {'bfloat16' if bf16 else 'float32'} over float32 parameters; "
            f"encoder remat {'on' if remat else 'off'}") in log
    state = ckpt_lib.load_checkpoint(os.path.join(trainer.exp_dir, "epoch_0"))
    for comp in ckpt_lib.COMPONENTS:
        assert all(v.dtype == torch.float32 for v in state[comp].values()
                   if v.is_floating_point())


def test_train_esptt_bf16(corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "esp.yaml")
    dump_config(Config(espnet_train_config(*corpus)), path)
    trainer = train_esptt.main(["-config", path, "--device", "cpu", "--epochs", "1",
                                "--bf16", "--remat"])
    assert trainer.is_espnet and trainer.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    log = _log(trainer)
    assert "the espnet family ignores it" in log and log.count("CER:") == 1
    assert "nan" not in log.lower()


def test_bf16_checkpoint_is_float32_and_continues(corpus, tmp_path, monkeypatch):
    """A bf16 run's checkpoint holds float32 parameters and optimizer state;
    ``-mode continue --bf16`` resumes from it with the weights as saved."""
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "tiny.yaml")
    dump_config(_cfg(corpus), path)
    first = train_app.main(["-config", path, "--device", "cpu", "--epochs", "1", "--bf16"])
    state = ckpt_lib.load_checkpoint(os.path.join(first.exp_dir, "epoch_0"))
    trace = state["optimizer"]["state"]["trace"]
    assert trace and all(x.dtype == torch.float32 for x in trace)
    again = train_app.main(["-config", path, "--device", "cpu", "--epochs", "2", "--bf16",
                            "-mode", "continue"])
    assert (again.start_epoch, again.global_step) == (1, 4)
    assert os.path.exists(os.path.join(again.exp_dir, "epoch_1", "model.pt"))
    assert "Continue from" in _log(again)


def test_jax_bf16_checkpoint_continues_under_port_bf16(tmp_path):
    """The JAX trainer at ``compute_dtype=bfloat16`` trains and saves epoch
    0; the port's ``-mode continue`` with bf16 loads its weights and counters,
    and its first bf16 step's loss is JAX's bf16 loss function's on the
    same batch (rtol 1e-5; the JAX trainer's jitted step's within 1e-3)."""
    root = str(tmp_path / "tones")
    vocab_path, csvs = make_tone_corpus(root, n_train=8, n_dev=4)
    cfg = tiny_train_config(root, vocab_path, csvs, n_enc=2, d_model=64)
    cfg.override("training.specaug", False)
    exp_root = str(tmp_path / "egs")
    first = JaxTrainer(cfg, exp_root=exp_root, compute_dtype=jnp.bfloat16)
    loader, _ = first.make_loaders()
    first.train_epoch(0, loader)
    first.save(0)
    del first

    jc = JaxTrainer(cfg, mode="continue", exp_root=exp_root, compute_dtype=jnp.bfloat16)
    pc = Trainer(Config(cfg.to_dict()), mode="continue", exp_root=exp_root, device="cpu",
                 compute_dtype=torch.bfloat16)
    assert (pc.start_epoch, pc.global_step) == (jc.start_epoch, jc.global_step) == (1, 2)
    start = from_jax_params(jax.device_get(jc.params))
    for name, p in pc.model.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p.detach(), start[name]), name
    loader, _ = jc.make_loaders()
    loader.epoch = 1
    batch = next(iter(loader))
    jc.rng, rng = jax.random.split(jc.rng)
    _, _, m_j = jc.train_step(jc.params, jc.opt_state, mesh_lib.shard_batch(batch, jc.mesh), rng)
    loss_j = jax_make_loss_fn(jc.model, jc.step_cfg)(
        jc.params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    m = pc.train_step(batch_to_device(batch, "cpu"), pc.gen)
    # the port rounds where JAX's bf16 code rounds run op by op; the
    # trainer's jitted step lets XLA keep float32 inside its fusions (its
    # excess precision), about 1e-4 of the loss away from both
    np.testing.assert_allclose(float(m["loss"]), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=1e-3)


def _deep_cfg(root, vocab_path, csvs, dropout, epochs):
    """The JAX smoke's config (``tests/test_deep_stability.py::_deep_cfg``)."""
    d = 64
    return Config({
        "data": {"name": "tone", "vocab": vocab_path,
                 "left_context_width": 3, "right_context_width": 0,
                 "feature_dim": d // 4, "subsample": 3,
                 "max_input_length": 40, "max_target_length": 6,
                 "batch_size": 4, "shuffle": True,
                 "train": csvs["train"], "dev": csvs["train"], "test": csvs["test"]},
        "model": {"type": "transducer",
                  "enc": {"max_input_length": 40, "n_head": 2, "d_model": d,
                          "d_head": d // 2, "d_inner": 128, "n_layer": 18,
                          "left_context": 10, "right_context": 2},
                  "dec": {"max_target_length": 6, "n_head": 2, "d_model": d,
                          "d_head": d // 2, "d_inner": 128, "n_layer": 2},
                  "joint": {"input_size": 2 * d, "inner_size": 64},
                  "vocab_size": 12, "dropout": dropout},
        "training": {"eval_or_not": False, "seed": 1, "epochs": epochs,
                     "specaug": False, "max_grad_norm": 200,
                     "visualization": False, "show_interval": 10000,
                     "save_model": "deep18", "steps_per_call": 2,
                     "nan_guard": True},
        "optim": {"type": "adam", "lr": 1e-3, "schedule": "step_decay",
                  "warmup_steps": 40, "hold_steps": 200, "final_step": 500,
                  "init_lr": 1e-4, "min_lr": 1e-4, "decay_ratio": 1.0,
                  "weight_decay": 0, "begin_to_adjust_lr": 10_000},
    })


def test_depth18_bf16_remat_dropout_stability_smoke(tmp_path):
    """18 post-LN layers at d64, bf16 + remat + dropout 0.1 + nan-guard, the
    JAX smoke's schedule and 30 epochs (60 updates): every epoch loss
    finite, no update skipped, and the last quarter's mean under 0.75 x
    the first quarter's."""
    root = str(tmp_path / "tones")
    vocab_path, csvs = make_tone_corpus(root, n_train=8, n_dev=4, n_classes=4)
    epochs = 30
    trainer = Trainer(_deep_cfg(root, vocab_path, csvs, 0.1, epochs),
                      exp_root=str(tmp_path / "egs"), device="cpu",
                      compute_dtype=torch.bfloat16, remat=True)
    assert len(trainer.model.encoder.layers) == 18 and trainer.model.encoder.remat
    train_loader, _ = trainer.make_loaders()
    losses = np.asarray([trainer.train_epoch(epoch, train_loader) for epoch in range(epochs)])
    assert np.isfinite(losses).all(), losses
    assert trainer.total_skips == 0
    q = max(1, len(losses) // 4)
    head, tail = losses[:q].mean(), losses[-q:].mean()
    assert tail < 0.75 * head, f"no descent at depth 18: {head:.3f} -> {tail:.3f}"
