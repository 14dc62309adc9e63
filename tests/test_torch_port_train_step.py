"""PyTorch port: the training step held against the JAX package's
``make_train_step`` (``TrainStepConfig(specaug=False)``) on the same weights
and batch: losses, raw gradient norms and every parameter after one and
three steps, for the dense, flash and banded models (on the CPU the port's
kernels take their plain versions; JAX runs its Pallas kernels in interpret
mode).  Parameters come back to the JAX layout through
``utils/torch_convert.transducer_params``.  fp32, tolerance ``TOL`` (rtol
2e-4, atol 2e-5)."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from transformer_transducer_tpu.models.transducer import build_transducer as jax_build
from transformer_transducer_tpu.training import optim as jax_optim
from transformer_transducer_tpu.training.train_step import (
    TrainStepConfig as JaxStepConfig, make_train_step as jax_make_train_step)
from transformer_transducer_tpu.utils.config import Config as JaxConfig
from transformer_transducer_tpu.utils.torch_convert import transducer_params
from transformer_transducer_tpu_torch.training.optim import build_optimizer
from transformer_transducer_tpu_torch.training.train_step import (
    TrainStepConfig, batch_to_device, make_eval_loss_step, make_train_step)
from transformer_transducer_tpu_torch.utils.config import Config

from torch_port_helpers import TOL, port_model, tiny_model_cfg, to_numpy_tree

torch.set_num_threads(1)

V = 30
OPTIMS = {
    "sgd": ({"type": "sgd", "lr": 0.01, "momentum": 0.9}, 200.0),
    "adam_l2_clip": ({"type": "adam", "lr": 1e-3, "weight_decay": 0.01}, 0.5),
    "step_decay": ({"type": "sgd", "lr": 0.02, "momentum": 0.9,
                    "schedule": "step_decay", "warmup_steps": 2,
                    "hold_steps": 3, "final_step": 6, "init_lr": 0.005,
                    "min_lr": 0.001}, 200.0),
}


def _batch(seed, b=3, tlen=20, u=5):
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randn(b, tlen, 64).astype(np.float32),
            "inputs_length": np.array([tlen] + list(rng.randint(8, tlen + 1, b - 1))),
            "targets": rng.randint(1, V, (b, u)),
            "targets_length": np.array([u] + list(rng.randint(1, u + 1, b - 1)))}


def _models(kind, seed=0):
    cfg = tiny_model_cfg(vocab=V)
    model_j = jax_build(JaxConfig(copy.deepcopy(cfg)), flash=kind == "flash",
                        banded=kind == "banded")
    variables = to_numpy_tree(model_j.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 64)), jnp.zeros((1, 4), jnp.int32)))
    model = port_model(cfg, variables)
    if kind == "flash":
        model = _rebuild(cfg, variables, flash=True)
    elif kind == "banded":
        model = _rebuild(cfg, variables, banded=True)
    return model_j, variables["params"], model


def _rebuild(cfg, variables, **kw):
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.utils.convert import from_jax_params
    model = build_transducer(Config(copy.deepcopy(cfg)), device="cpu", **kw)
    model.load_state_dict(from_jax_params(variables["params"]))
    return model


def _port_params(model):
    sd = lambda m: {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}
    return transducer_params(sd(model.encoder), sd(model.decoder),
                             sd(model.joint))["params"]


def _assert_params_close(params, params_j):
    got = jax.tree_util.tree_leaves_with_path(params)
    want = dict(jax.tree_util.tree_leaves_with_path(params_j))
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_allclose(leaf, np.asarray(want[path]),
                                   err_msg=jax.tree_util.keystr(path), **TOL)


def _run_both(kind, optim, max_norm, batches, accum=1, nan_guard=False):
    model_j, params_j, model = _models(kind)
    tx = jax_optim.build_optimizer(JaxConfig(dict(optim)), max_grad_norm=max_norm)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum).gradient_transformation()
    step_j = jax.jit(jax_make_train_step(
        model_j, tx, JaxStepConfig(specaug=False, nan_guard=nan_guard)))
    opt_state = tx.init(params_j)
    opt = build_optimizer(Config(dict(optim)), list(model.parameters()),
                          max_grad_norm=max_norm, grad_accum_steps=accum)
    step = make_train_step(model, opt, TrainStepConfig(specaug=False,
                                                       nan_guard=nan_guard))
    metrics, snapshots = [], []
    for batch in batches:
        params_j, opt_state, m_j = step_j(params_j, opt_state,
                                          {k: jnp.asarray(v) for k, v in batch.items()},
                                          jax.random.PRNGKey(0))
        m = step(batch_to_device(batch, "cpu"), None)
        metrics.append((m, m_j))
        snapshots.append((_port_params(model), params_j))
    return model, opt, snapshots, metrics


@pytest.mark.parametrize("kind,optim", [
    ("dense", "sgd"), ("dense", "adam_l2_clip"), ("dense", "step_decay"),
    ("flash", "sgd"), ("banded", "sgd")])
def test_steps_match_jax(kind, optim):
    """Step 1 and step 3: losses, raw gradient norms, parameters."""
    cfg, max_norm = OPTIMS[optim]
    batches = [_batch(seed) for seed in range(3)]
    model, opt, snapshots, metrics = _run_both(kind, cfg, max_norm, batches)
    for m, m_j in metrics:
        np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), **TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(m_j["grad_norm"]),
                                   **TOL)
    if optim == "adam_l2_clip":     # the clip bites
        assert all(float(m["grad_norm"]) > max_norm for m, _ in metrics)
    assert opt.count == 3
    _assert_params_close(*snapshots[0])
    _assert_params_close(*snapshots[2])


def test_nan_guard_keeps_params_and_optimizer_state():
    cfg, max_norm = OPTIMS["sgd"]
    bad = _batch(1)
    bad["inputs"][0, 0, 0] = np.nan
    model, opt, snapshots, metrics = _run_both(
        "dense", cfg, max_norm, [_batch(0), bad], nan_guard=True)
    (m0, _), (m1, m1_j) = metrics
    assert m0["skipped"] == 0 and m1["skipped"] == 1 == int(m1_j["skipped"])
    assert opt.count == 1
    _assert_params_close(*snapshots[1])
    before = [p.detach().clone() for p in model.parameters()]
    trace = [x.clone() for x in opt.state["trace"]]
    step = make_train_step(model, opt, TrainStepConfig(specaug=False, nan_guard=True))
    assert step(batch_to_device(bad, "cpu"), None)["skipped"] == 1
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(trace, opt.state["trace"]))


def test_grad_accumulation_matches_jax_multisteps():
    cfg, max_norm = OPTIMS["sgd"]
    batches = [_batch(seed) for seed in range(4)]
    model, opt, snapshots, metrics = _run_both("dense", cfg, max_norm, batches,
                                               accum=2)
    for m, m_j in metrics:
        np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), **TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(m_j["grad_norm"]),
                                   **TOL)
    assert opt.count == 2 and opt.mini_step == 0
    for snap in snapshots:
        _assert_params_close(*snap)


def test_eval_loss_step_gives_per_utterance_losses():
    from transformer_transducer_tpu.training.train_step import make_eval_loss_step as jax_eval
    model_j, params_j, model = _models("dense")
    batch = _batch(5)
    want = jax_eval(model_j, JaxStepConfig())(params_j, {k: jnp.asarray(v)
                                                         for k, v in batch.items()})
    got = make_eval_loss_step(model, TrainStepConfig())(batch_to_device(batch, "cpu"))
    assert got.shape == (3,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
