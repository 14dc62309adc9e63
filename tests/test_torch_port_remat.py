"""PyTorch port: ``--remat``, per-layer recomputation of the encoder
(``torch.utils.checkpoint`` around each layer, JAX ``nn.remat``).

With dropout on and the generators seeded alike, the gradients with and
without remat are equal to the bit (the recomputation replays each layer's
dropout masks from the saved random state), in float32 and under bf16, for
the dense, banded and flash models (on the CPU the kernels take their plain
versions).  With dropout off they match the JAX package's ``remat=True``
gradients within rtol 2e-4 / atol 2e-5 (plus 1e-6 of each leaf's largest
magnitude, as the port's other gradient tests hold the untrained label
encoder's large LayerNorm gradients).  The label encoder is not
recomputed, and the espnet family, which JAX builds without remat,
ignores the flag with a log line."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_helpers import make_tone_corpus
from transformer_transducer_tpu.models.transducer import build_transducer as jax_build
from transformer_transducer_tpu.training.train_step import (
    TrainStepConfig as JaxStepConfig, make_loss_fn as jax_make_loss_fn)
from transformer_transducer_tpu.utils.config import Config as JaxConfig
from transformer_transducer_tpu_torch.models.transducer import build_transducer
from transformer_transducer_tpu_torch.training.train_step import (
    TrainStepConfig, batch_to_device, make_loss_fn)
from transformer_transducer_tpu_torch.training.trainer import Trainer
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.convert import from_jax_params

from torch_port_helpers import TOL, espnet_train_config, tiny_model_cfg, to_numpy_tree

torch.set_num_threads(1)

V = 30


def _batch(seed, b=3, tlen=20, u=5):
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randn(b, tlen, 64).astype(np.float32),
            "inputs_length": np.array([tlen] + list(rng.randint(8, tlen + 1, b - 1))),
            "targets": rng.randint(1, V, (b, u)),
            "targets_length": np.array([u] + list(rng.randint(1, u + 1, b - 1)))}


def _variables(cfg, seed=0):
    model = jax_build(JaxConfig(copy.deepcopy(cfg)))
    return to_numpy_tree(model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 64)),
                                    jnp.zeros((1, 4), jnp.int32)))


def _port_grads(cfg, variables, kind, remat, batch, compute_dtype=torch.float32, seed=11):
    model = build_transducer(Config(copy.deepcopy(cfg)), device="cpu", flash=kind == "flash",
                             banded=kind == "banded", remat=remat,
                             compute_dtype=compute_dtype)
    model.load_state_dict(from_jax_params(variables["params"]))
    model.train()
    assert model.encoder.remat is remat
    torch.manual_seed(seed)                          # the dropout stream
    loss = make_loss_fn(model, TrainStepConfig(specaug=False))(
        batch_to_device(batch, "cpu"), None)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("kind,dtype", [
    ("dense", "float32"), ("dense", "bfloat16"), ("banded", "float32"),
    ("banded", "bfloat16"), ("flash", "float32"), ("flash", "bfloat16")])
def test_remat_gradients_equal_plain_gradients_to_the_bit(kind, dtype):
    """Dropout 0.1 on, the same seed: the loss and every gradient equal."""
    cfg = tiny_model_cfg(vocab=V)
    cfg["dropout"] = 0.1
    variables = _variables(cfg)
    batch = _batch(3)
    cd = getattr(torch, dtype)
    loss_a, plain = _port_grads(cfg, variables, kind, False, batch, cd)
    loss_b, remat = _port_grads(cfg, variables, kind, True, batch, cd)
    assert torch.equal(loss_a, loss_b)
    for name, grad in plain.items():
        assert torch.equal(grad, remat[name]), name
    # the dropout masks differ from those of another seed: dropout is on
    loss_c, _ = _port_grads(cfg, variables, kind, True, batch, cd, seed=12)
    assert not torch.equal(loss_a, loss_c)


@pytest.mark.parametrize("kind", ["dense", "flash"])
def test_remat_gradients_match_jax_remat(kind):
    """Dropout off: the port's remat gradients against JAX's
    ``build_transducer(remat=True)`` on the same weights and batch (JAX's
    ``nn.remat`` layer cannot take the band, a traced argument there, so
    the banded model is held to the port's own plain gradients above)."""
    cfg = tiny_model_cfg(vocab=V)
    variables = _variables(cfg, seed=1)
    batch = _batch(4)
    model_j = jax_build(JaxConfig(copy.deepcopy(cfg)), remat=True, flash=kind == "flash")
    loss_j, grads_j = jax.value_and_grad(jax_make_loss_fn(model_j, JaxStepConfig(specaug=False)))(
        variables["params"], {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    loss, grads = _port_grads(cfg, variables, kind, True, batch)
    np.testing.assert_allclose(float(loss), float(loss_j), **TOL)
    want = from_jax_params(jax.device_get(grads_j))
    assert set(want) == set(grads)
    for name, grad in grads.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(grad.numpy(), ref, rtol=TOL["rtol"],
                                   atol=TOL["atol"] + 1e-6 * np.abs(ref).max(),
                                   err_msg=name)


def test_remat_recomputes_the_encoder_layers_only():
    """Each encoder layer's forward runs twice in a remat step (once more in
    the backward), the label encoder's once; without gradients, once."""
    cfg = tiny_model_cfg(vocab=V)
    model = build_transducer(Config(copy.deepcopy(cfg)), device="cpu", remat=True)
    model.load_state_dict(from_jax_params(_variables(cfg)["params"]))
    calls = {"enc": 0, "dec": 0}

    def counted(layer, key):
        forward = layer.forward

        def run(*args, **kw):
            calls[key] += 1
            return forward(*args, **kw)
        layer.forward = run           # (module hooks do not fire in a recompute)
    for layer in model.encoder.layers:
        counted(layer, "enc")
    for layer in model.decoder.layers:
        counted(layer, "dec")
    loss_fn = make_loss_fn(model, TrainStepConfig(specaug=False))
    loss_fn(batch_to_device(_batch(5), "cpu"), None).backward()
    assert calls == {"enc": 4, "dec": 2}
    with torch.no_grad():
        loss_fn(batch_to_device(_batch(5), "cpu"), None, train=False)
    assert calls == {"enc": 6, "dec": 4}


def test_espnet_family_ignores_remat_with_a_log_line(tmp_path):
    root = str(tmp_path / "tones")
    vocab_path, csvs = make_tone_corpus(root, n_train=4, n_dev=2)
    cfg = Config(espnet_train_config(root, vocab_path, csvs))
    trainer = Trainer(cfg, exp_root=str(tmp_path / "egs"), device="cpu", remat=True)
    log = open(os.path.join(trainer.exp_dir, "train.log"), encoding="utf-8").read()
    assert "the espnet family ignores it" in log
    assert "encoder remat off" in log
