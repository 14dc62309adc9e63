"""PyTorch port: Transducer, label cache and weight carry-over held against
the JAX package on the same weights.  fp32, tolerance ``TOL`` (rtol 2e-4,
atol 2e-5)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from transformer_transducer_tpu.ops.masks import (
    context_mask as jax_context_mask, look_ahead_mask as jax_look_ahead_mask)
from transformer_transducer_tpu.utils.torch_convert import transducer_params
from transformer_transducer_tpu_torch.decoding import label_cache
from transformer_transducer_tpu_torch.ops.masks import context_mask, look_ahead_mask

from torch_port_helpers import (
    TOL, jax_model, port_model, t, tiny_model_cfg)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_model_cfg()
    jm, variables = jax_model(cfg, seed=1)
    return jm, variables, port_model(cfg, variables)


def _feats(b, tlen, seed):
    return np.random.RandomState(seed).randn(b, tlen, 64).astype(np.float32)


@pytest.mark.parametrize("tlen", [1, 37, 150])
@pytest.mark.parametrize("mask_kind", ["none", "context"])
def test_encode_matches_jax(models, tlen, mask_kind):
    jm, variables, pm = models
    x = _feats(2, tlen, seed=tlen)
    jmask = None if mask_kind == "none" else jax_context_mask(tlen, 10, 2)
    mask = None if mask_kind == "none" else context_mask(tlen, 10, 2)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), jmask, method="encode"))
    with torch.no_grad():
        got = pm.encode(t(x), mask).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("tlen", [37, 150])
def test_encode_banded_matches_jax(models, tlen):
    """The port's band path vs the JAX Pallas band path and the JAX masked
    dense encode (T = 150 > k_len = 120 exercises the front-pad rule)."""
    jm, variables, pm = models
    x = _feats(2, tlen, seed=10 + tlen)
    with torch.no_grad():
        got = pm.encode_banded(t(x), 10, 2).numpy()
    banded = jm.apply(variables, jnp.asarray(x), 10, 2, method="encode_banded")
    masked = jm.apply(variables, jnp.asarray(x), jax_context_mask(tlen, 10, 2),
                      method="encode")
    np.testing.assert_allclose(got, np.asarray(banded), **TOL)
    np.testing.assert_allclose(got, np.asarray(masked), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_predict_matches_jax(models, masked):
    jm, variables, pm = models
    tokens = np.random.RandomState(2).randint(0, 50, (3, 9)).astype(np.int32)
    tokens[:, 0] = 0
    jmask = jax_look_ahead_mask(9) if masked else None
    ref = np.asarray(jm.apply(variables, jnp.asarray(tokens), jmask,
                              method="predict"))
    with torch.no_grad():
        got = pm.predict(t(tokens).long(), look_ahead_mask(9) if masked else None)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_full_logits_match_jax(models):
    """(B, T, U+1, V) logits of the full forward: blank-prefixed targets,
    look-ahead label mask, no audio mask."""
    jm, variables, pm = models
    x = _feats(2, 23, seed=4)
    y = np.random.RandomState(5).randint(1, 50, (2, 6)).astype(np.int32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = pm(t(x), t(y).long()).numpy()
    assert got.shape == (2, 23, 7, 50)
    np.testing.assert_allclose(got, ref, **TOL)


def test_joint_logits_vector_path_matches_jax(models):
    jm, variables, pm = models
    rng = np.random.RandomState(6)
    enc, dec = rng.randn(4, 64).astype(np.float32), rng.randn(4, 64).astype(np.float32)
    ref = jm.apply(variables, jnp.asarray(enc), jnp.asarray(dec),
                   method="joint_logits")
    with torch.no_grad():
        got = pm.joint_logits(t(enc), t(dec)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_tied_projection_matches_jax():
    cfg = tiny_model_cfg(share_embedding=True)
    jm, variables = jax_model(cfg, seed=2)
    pm = port_model(cfg, variables)
    assert "joint.project_layer.weight" not in pm.state_dict()
    x = _feats(1, 11, seed=7)
    y = np.random.RandomState(8).randint(1, 50, (1, 4)).astype(np.int32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = pm(t(x), t(y).long()).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_weights_round_trip_through_torch_convert(models):
    """from_jax_params, then the JAX package's torch_convert.transducer_params
    on the port's component state dicts, gives back the JAX tree exactly."""
    _, variables, pm = models
    to_np = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    back = transducer_params(to_np(pm.encoder), to_np(pm.decoder),
                             to_np(pm.joint))
    ref_leaves = jax.tree_util.tree_leaves_with_path(variables)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(back_leaves) == {p for p, _ in ref_leaves}
    for path, leaf in ref_leaves:
        np.testing.assert_array_equal(back_leaves[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("cap", [12, 50])
def test_label_cache_step_matches_predict(models, cap):
    """Cached step u == predict(history, look_ahead_mask)[u]; cap 50 > the
    label encoder's k_len 42 reads table row 0 past the table (front pad)."""
    _, _, pm = models
    rng = np.random.RandomState(cap)
    tokens = torch.from_numpy(rng.randint(1, 50, (2, cap))).long()
    tokens[:, 0] = 0
    hist1, outs1 = [], []                  # row 1 skips every third token
    with torch.no_grad():
        full = pm.predict(tokens, look_ahead_mask(cap))
        cache = label_cache.init_cache(pm.decoder, 2, cap)
        for u in range(cap):
            update = torch.tensor([True, u % 3 != 2])
            out, cache = label_cache.step(pm.decoder, tokens[:, u], cache, update)
            np.testing.assert_allclose(out[0].numpy(), full[0, u].numpy(), **TOL)
            if update[1]:
                hist1.append(int(tokens[1, u]))
                outs1.append(out[1].numpy())
        ref1 = pm.predict(torch.tensor([hist1]), look_ahead_mask(len(hist1)))
    np.testing.assert_allclose(np.stack(outs1), ref1[0].numpy(), **TOL)
    assert cache["idx"].tolist() == [cap, len(hist1)]
