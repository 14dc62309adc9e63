"""PyTorch port: the training step held against the JAX package's
``make_train_step`` (``TrainStepConfig(specaug=False)``) on the same weights
and batch: losses, raw gradient norms and every parameter after one and
three steps, for the dense, flash and banded models, with the full and the
pruned loss (on the CPU the port's
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
    TrainStepConfig as JaxStepConfig, make_eval_loss_step as jax_eval,
    make_loss_fn as jax_make_loss_fn, make_train_step as jax_make_train_step)
from transformer_transducer_tpu.utils.config import Config as JaxConfig
from transformer_transducer_tpu.utils.torch_convert import transducer_params
from transformer_transducer_tpu_torch.training.optim import build_optimizer
from transformer_transducer_tpu_torch.training.train_step import (
    TrainStepConfig, batch_to_device, make_eval_loss_step, make_loss_fn,
    make_train_step)
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


def _port_params(model, grads=False):
    """The port's parameters (or, with ``grads``, their gradients) in the JAX
    layout."""
    if grads:
        sd = lambda m: {k: v.grad.numpy().copy() for k, v in m.named_parameters()}
    else:
        sd = lambda m: {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}
    return transducer_params(sd(model.encoder), sd(model.decoder),
                             sd(model.joint))["params"]


def _assert_params_close(params, params_j, scaled_atol=0.0):
    """Leaf by leaf within ``TOL``; ``scaled_atol`` adds that multiple of the
    leaf's largest magnitude to the absolute tolerance."""
    got = jax.tree_util.tree_leaves_with_path(params)
    want = dict(jax.tree_util.tree_leaves_with_path(params_j))
    assert len(got) == len(want)
    for path, leaf in got:
        ref = np.asarray(want[path])
        np.testing.assert_allclose(
            leaf, ref, err_msg=jax.tree_util.keystr(path), rtol=TOL["rtol"],
            atol=TOL["atol"] + scaled_atol * np.abs(ref).max())


def _run_both(kind, optim, max_norm, batches, accum=1, nan_guard=False, **loss_kw):
    """``loss_kw``: the loss fields of both step configs (loss_pruned_range,
    loss_simple_scale)."""
    model_j, params_j, model = _models(kind)
    tx = jax_optim.build_optimizer(JaxConfig(dict(optim)), max_grad_norm=max_norm)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum).gradient_transformation()
    step_j = jax.jit(jax_make_train_step(
        model_j, tx, JaxStepConfig(specaug=False, nan_guard=nan_guard, **loss_kw)))
    opt_state = tx.init(params_j)
    opt = build_optimizer(Config(dict(optim)), list(model.parameters()),
                          max_grad_norm=max_norm, grad_accum_steps=accum)
    step = make_train_step(model, opt, TrainStepConfig(specaug=False,
                                                       nan_guard=nan_guard, **loss_kw))
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
    model_j, params_j, model = _models("dense")
    batch = _batch(5)
    want = jax_eval(model_j, JaxStepConfig())(params_j, {k: jnp.asarray(v)
                                                         for k, v in batch.items()})
    got = make_eval_loss_step(model, TrainStepConfig())(batch_to_device(batch, "cpu"))
    assert got.shape == (3,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["dense", "flash"])
@pytest.mark.parametrize("simple_scale", [0.25, 0.0])
def test_pruned_loss_fn_and_gradients_match_jax(kind, simple_scale):
    """``make_loss_fn`` with ``loss_pruned_range=3``: the loss and the
    gradient of every parameter against JAX's on the same weights.  The
    untrained label encoder's layer-norm biases get gradients of about 5e7
    (the full loss's too), so a leaf's small elements carry fp32 rounding of
    its large ones: the absolute tolerance adds 1e-6 of each leaf's largest
    magnitude."""
    model_j, params_j, model = _models(kind)
    batch = _batch(7)
    kw = dict(specaug=False, loss_pruned_range=3, loss_simple_scale=simple_scale)
    loss_j, grads_j = jax.value_and_grad(jax_make_loss_fn(model_j, JaxStepConfig(**kw)))(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    model.train()
    loss = make_loss_fn(model, TrainStepConfig(**kw))(batch_to_device(batch, "cpu"), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), **TOL)
    _assert_params_close(_port_params(model, grads=True), grads_j, scaled_atol=1e-6)


def test_pruned_steps_match_jax():
    """Three SGD steps on the pruned loss: losses, gradient norms and the
    parameters after steps 1 and 3."""
    cfg, max_norm = OPTIMS["sgd"]
    batches = [_batch(seed) for seed in range(3)]
    model, opt, snapshots, metrics = _run_both("dense", cfg, max_norm, batches,
                                               loss_pruned_range=3)
    for m, m_j in metrics:
        np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), **TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(m_j["grad_norm"]),
                                   **TOL)
    _assert_params_close(*snapshots[0])
    _assert_params_close(*snapshots[2])


def test_eval_step_reports_the_full_nll_when_training_is_pruned():
    model_j, params_j, model = _models("dense")
    batch = _batch(5)
    pruned = TrainStepConfig(loss_pruned_range=2)
    got = make_eval_loss_step(model, pruned)(batch_to_device(batch, "cpu"))
    full = make_eval_loss_step(model, TrainStepConfig())(batch_to_device(batch, "cpu"))
    assert torch.equal(got, full)
    want = jax_eval(model_j, JaxStepConfig(loss_pruned_range=2))(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert pruned.loss_pruned_range == 2            # the caller's config stays
