"""PyTorch port: training the espnet family — the fused and the pruned loss
and their gradients (``training/train_step.py``'s espnet branch: encode
with the lengths, the loss over ``encoded_lengths``, the joint's
activation), SGD steps, the trainer end to end, ``apps/train_esptt.py``,
and ``-mode continue`` from a JAX espnet directory, held against the JAX
package's step and trainer on the same weights and batches; mirrors
``tests/test_espnet_training.py`` and the loss tests of
``tests/test_espnet_variant.py``.

Losses, gradients and parameters within ``TOL`` (rtol 2e-4, atol 2e-5;
gradients with 1e-6 of each leaf's largest magnitude added to the absolute
tolerance, as the native family's tests hold them).  One exception, bounded
in place and in count: under the pruned loss the untrained joint's
``lin_dec`` and ``lin_out`` gradients are sums over every (t, u) cell of
the band, and a few of their elements (measured: 3 of 1280 in ``lin_dec``,
at most 1.77 x the tolerance, and 2 of 1200 in ``lin_out``, at most 1.57 x,
in the tanh case; none in the others) come out further apart.  Each such
element must stay within 2 x the tolerance of JAX's, there may be at most
``SPREAD_CAP`` of them in a leaf, and the port's float32 value must be the
nearer of the two to the port's float64 rerun.  Every other leaf, and every
leaf of the full loss, is held to the tolerance alone.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_helpers import make_corpus
from transformer_transducer_tpu.parallel import mesh as mesh_lib
from transformer_transducer_tpu.training import optim as jax_optim
from transformer_transducer_tpu.training.train_step import (
    TrainStepConfig as JaxStepConfig, make_loss_fn as jax_make_loss_fn,
    make_train_step as jax_make_train_step)
from transformer_transducer_tpu.training.trainer import Trainer as JaxTrainer
from transformer_transducer_tpu.utils import checkpoint as jax_ckpt
from transformer_transducer_tpu.utils.config import Config as JaxConfig
from transformer_transducer_tpu_torch.apps import train_esptt
from transformer_transducer_tpu_torch.models.espnet_variant import EspnetTransducer
from transformer_transducer_tpu_torch.training.optim import build_optimizer
from transformer_transducer_tpu_torch.training.train_step import (
    TrainStepConfig, batch_to_device, make_loss_fn, make_train_step)
from transformer_transducer_tpu_torch.training.trainer import Trainer
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.convert import from_jax_params

from torch_port_helpers import (
    TOL, espnet_train_config, jax_espnet_model, port_espnet_model, tiny_espnet_cfg)

torch.set_num_threads(1)

V = 30
D = 32


def _batch(seed, b=3, tlen=41, u=6, d=D):
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randn(b, tlen, d).astype(np.float32),
            "inputs_length": np.array([tlen] + list(rng.randint(17, tlen + 1, b - 1))),
            "targets": rng.randint(1, V - 1, (b, u)),
            "targets_length": np.array([u] + list(rng.randint(1, u + 1, b - 1)))}


# the pruned loss's joint leaves whose band-wide float32 sums may spread past
# the tolerance in a few elements (see the module docstring), and how many
SPREAD_LEAVES = ("joint.lin_dec.weight", "joint.lin_out.weight")
SPREAD_CAP = 4


def _grads_close(model, grads_j, exact_grads, pruned):
    """Every parameter's gradient against the JAX tree's, mapped to the
    port's names (``from_jax_params``), within the tolerance; under the
    pruned loss, ``SPREAD_LEAVES`` may each hold up to ``SPREAD_CAP``
    elements within 2 x the tolerance where the port is the nearer to
    ``exact_grads()`` (the port in float64)."""
    want = from_jax_params(jax.device_get(grads_j))
    exact = None
    for name, p in model.named_parameters():
        got, ref = p.grad.numpy(), want[name].numpy()
        tol = TOL["atol"] + 1e-6 * np.abs(ref).max() + TOL["rtol"] * np.abs(ref)
        off = np.abs(got - ref) > tol
        if not off.any():
            continue
        assert pruned and name in SPREAD_LEAVES, (name, int(off.sum()))
        assert off.sum() <= SPREAD_CAP, (name, int(off.sum()))
        assert (np.abs(got - ref) <= 2 * tol).all(), name
        exact = exact_grads() if exact is None else exact
        x = exact[name]
        assert (np.abs(got - x) < np.abs(ref - x))[off].all(), name


def _float64_grads(cfg, variables, batch, kw):
    pm = port_espnet_model(cfg, variables).double().train()
    b = batch_to_device(batch, "cpu")
    b["inputs"] = b["inputs"].double()
    make_loss_fn(pm, TrainStepConfig(**kw))(b, None).backward()
    return {n: p.grad.numpy() for n, p in pm.named_parameters()}


@pytest.mark.parametrize("input_layer,activation,pruned", [
    (None, "tanh", None), (None, "relu", None), ("conv2d", "tanh", None),
    ("linear", "tanh", None), (None, "tanh", 3), (None, "relu", 3), ("conv2d6", "tanh", 3)])
def test_loss_and_gradients_match_jax(input_layer, activation, pruned):
    """``make_loss_fn``, the full and the pruned loss: a conv input layer's
    loss runs over its ``encoded_lengths``; a relu joint's activation
    reaches both losses."""
    cfg = tiny_espnet_cfg(input_layer, vocab=V, d=D, activation=activation)
    jm, variables = jax_espnet_model(cfg, seed=1)
    pm = port_espnet_model(cfg, variables)
    batch = _batch(7)
    kw = dict(specaug=False, loss_pruned_range=pruned)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm, JaxStepConfig(**kw))))(
        variables["params"], {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    pm.train()
    loss = make_loss_fn(pm, TrainStepConfig(**kw))(batch_to_device(batch, "cpu"), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), **TOL)
    _grads_close(pm, grads_j, lambda: _float64_grads(cfg, variables, batch, kw),
                 pruned is not None)


def test_sgd_steps_match_jax():
    """Three SGD steps (momentum 0.9, clip 200), full loss then pruned:
    losses, gradient norms and the parameters after each."""
    cfg = tiny_espnet_cfg(vocab=V, d=D)
    jm, variables = jax_espnet_model(cfg, seed=2)
    pm = port_espnet_model(cfg, variables)
    optim = {"type": "sgd", "lr": 0.01, "momentum": 0.9}
    for pruned in (None, 3):
        tx = jax_optim.build_optimizer(JaxConfig(dict(optim)), max_grad_norm=200.0)
        step_j = jax.jit(jax_make_train_step(
            jm, tx, JaxStepConfig(specaug=False, loss_pruned_range=pruned)))
        params_j = variables["params"] if pruned is None else params_j
        opt_state = tx.init(params_j)
        opt = build_optimizer(Config(dict(optim)), list(pm.parameters()), max_grad_norm=200.0)
        step = make_train_step(pm, opt, TrainStepConfig(specaug=False,
                                                        loss_pruned_range=pruned))
        for seed in range(3):
            batch = _batch(seed)
            params_j, opt_state, m_j = step_j(params_j, opt_state,
                                              {k: jnp.asarray(v) for k, v in batch.items()},
                                              jax.random.PRNGKey(0))
            m = step(batch_to_device(batch, "cpu"), None)
            np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), **TOL)
            np.testing.assert_allclose(float(m["grad_norm"]), float(m_j["grad_norm"]), **TOL)
        want = from_jax_params(jax.device_get(params_j))
        for name, p in pm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), **TOL,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# the trainer and the CLIs

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("espnet_corpus"))
    vocab_path, csvs = make_corpus(root, n_train=8, n_dev=4)
    return vocab_path, csvs, root


def _cfg(corpus, **overrides):
    vocab_path, csvs, root = corpus
    cfg = JaxConfig(espnet_train_config(root, vocab_path, csvs))
    cfg.override("training.specaug", False)
    cfg.override("optim.lr", 0.02)
    for key, value in overrides.items():
        cfg.override(key, value)
    return cfg


def test_trainer_end_to_end(corpus, tmp_path):
    """Two epochs train (the loss falls), the evaluation decodes from sos
    to a finite CER (JAX ``test_espnet_trainer_end_to_end``); ``--flash``
    and ``--banded`` are ignored, as the JAX trainer ignores them."""
    trainer = Trainer(Config(_cfg(corpus).to_dict()), exp_root=str(tmp_path / "egs"),
                      flash=True, device="cpu")
    assert trainer.is_espnet and isinstance(trainer.model, EspnetTransducer)
    train_loader, dev_loader = trainer.make_loaders()
    losses = [trainer.train_epoch(e, train_loader) for e in range(2)]
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    assert np.isfinite(trainer.evaluate(1, dev_loader))
    log = open(os.path.join(trainer.exp_dir, "train.log"), encoding="utf-8").read()
    assert "the espnet family ignores them" in log


def test_conv_input_layer_evaluates_over_subsampled_lengths(corpus, tmp_path):
    """A conv2d input layer: the evaluation decodes over the encoder's
    subsampled lengths, as the JAX trainer's does (its decode of the same
    weights gives the same transcripts)."""
    cfg = _cfg(corpus, **{"model.enc.input_layer": "conv2d"})
    jax_tr = JaxTrainer(cfg, exp_root=str(tmp_path / "jax"))
    port = Trainer(Config(cfg.to_dict()), exp_root=str(tmp_path / "port"), device="cpu")
    port.model.load_state_dict(from_jax_params(jax.device_get(jax_tr.params)))
    _, dev_loader = port.make_loaders()
    cer = port.evaluate(0, dev_loader, compute_loss=False)
    jax_cer = jax_tr.evaluate(0, jax_tr.make_loaders()[1])
    assert np.isfinite(cer) and cer == pytest.approx(jax_cer)
    dump = lambda tr: open(os.path.join(tr.exp_dir, "decode_0.txt"), encoding="utf-8").read()
    assert dump(port) == dump(jax_tr)


def test_train_esptt_defaults_to_the_espnet_config(monkeypatch):
    seen = []
    monkeypatch.setattr(train_esptt, "train_main", seen.append)
    train_esptt.main(["--device", "cpu"])
    train_esptt.main(["--config", "x.yaml"])
    assert seen == [["-config", "configs/espnet_aishell.yaml", "--device", "cpu"],
                    ["--config", "x.yaml"]]


def test_train_esptt_cli_trains_continues_and_serves(corpus, tmp_path, monkeypatch):
    """``apps/train_esptt.py`` for one epoch with the pruned loss, ``-mode
    continue`` for a second, then ``apps/predict.py`` on the ``epoch_1`` it
    wrote gives the trained model's greedy decode."""
    from transformer_transducer_tpu.utils.config import dump_config
    from transformer_transducer_tpu_torch.apps import predict as predict_app
    from transformer_transducer_tpu_torch.decoding.greedy import recognize
    from transformer_transducer_tpu_torch.ops import features_np as F
    from transformer_transducer_tpu_torch.data.wav import read_wave
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "esp.yaml")
    dump_config(_cfg(corpus), path)
    first = train_esptt.main(["-config", path, "--device", "cpu", "--epochs", "1",
                              "--pruned-range", "3"])
    assert first.step_cfg.loss_pruned_range == 3
    second = train_esptt.main(["-config", path, "--device", "cpu", "--epochs", "2",
                               "-mode", "continue"])
    assert second.start_epoch == 1 and second.global_step == 4
    ckpt = os.path.join(second.exp_dir, "epoch_1")
    assert os.path.isdir(ckpt)
    wav = corpus[1]["dev"].replace("dev.csv", os.path.join("wav", "dev_0.wav"))
    text = predict_app.main(["--config", path, "--checkpoint", ckpt, "--wav", wav,
                             "--device", "cpu"])
    wave, rate = read_wave(wav)
    feats = F.subsample(F.stack_frames(F.logmel_masked(wave, rate, 4), 3, 0), 3)
    want = recognize(second.model.eval(), torch.from_numpy(feats[None]), [feats.shape[0]],
                     max_tokens=7)[0]
    assert text == "".join(second.vocab.decode(want))


def _jax_step(trainer, batch):
    trainer.rng, rng = jax.random.split(trainer.rng)
    trainer.params, trainer.opt_state, _ = trainer.train_step(
        trainer.params, trainer.opt_state, mesh_lib.shard_batch(batch, trainer.mesh), rng)


def test_continue_from_a_jax_espnet_directory_matches_a_jax_step(corpus, tmp_path):
    """The JAX trainer trains epoch 0 of the espnet family and saves
    ``epoch_0`` with its momentum trace; the port's ``-mode continue``
    restores weights, optimizer state, rate and counters (the optax state
    through the espnet key map), and its first step equals the JAX
    trainer's first step after its own continue."""
    cfg = _cfg(corpus)
    exp_root = str(tmp_path / "egs")
    first = JaxTrainer(cfg, exp_root=exp_root)
    loader, _ = first.make_loaders()
    first.train_epoch(0, loader)
    first.lr_ctl.maybe_decay(0)
    first.opt_state = jax_optim.set_learning_rate(first.opt_state, first.lr_ctl.lr)
    first.save(0)
    del first

    jc = JaxTrainer(cfg, mode="continue", exp_root=exp_root)
    pc = Trainer(Config(cfg.to_dict()), mode="continue", exp_root=exp_root, device="cpu")
    assert (pc.start_epoch, pc.global_step) == (jc.start_epoch, jc.global_step) == (1, 2)
    assert pc.optimizer.count == 2 and set(pc.optimizer.state) == {"trace"}
    start = from_jax_params(jax.device_get(jc.params))
    for name, p in pc.model.named_parameters():
        assert torch.equal(p.detach(), start[name]), name
    loader, _ = jc.make_loaders()
    loader.epoch = 1
    batch = next(iter(loader))
    _jax_step(jc, batch)
    pc.train_step(batch_to_device(batch, "cpu"), pc.gen)
    want = from_jax_params(jax.device_get(jc.params))
    for name, p in pc.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


def test_load_model_encoder_and_decoder_from_jax_espnet(corpus, tmp_path):
    """``training.load_model``, ``load_encoder`` and ``load_decoder`` take
    JAX espnet directories, a partial one too."""
    cfg = _cfg(corpus)
    _, variables = jax_espnet_model(cfg["model"], seed=7)
    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    jax_ckpt.save_checkpoint(whole, variables["params"])
    jax_ckpt.save_partial_checkpoint(part, variables["params"], ["decoder"])
    want = from_jax_params(variables["params"])
    for i, (overrides, comps) in enumerate([
            ({"training.load_model": whole}, ("encoder", "decoder", "joint")),
            ({"training.load_encoder": whole, "training.load_decoder": part},
             ("encoder", "decoder"))]):
        port_cfg = Config(cfg.to_dict())
        for key, value in overrides.items():
            port_cfg.override(key, value)
        tr = Trainer(port_cfg, exp_root=str(tmp_path / f"egs{i}"), device="cpu")
        for name, p in tr.model.named_parameters():
            assert torch.equal(p.detach(), want[name]) == name.startswith(comps), name
