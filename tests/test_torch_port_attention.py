"""PyTorch port: rel-position attention and its two kernels' plain versions
held against the JAX package (Pallas kernels in interpret mode, and the
dense masked branch).  fp32, tolerance ``TOL`` (rtol 2e-4, atol 2e-5)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from transformer_transducer_tpu.models.attention import (
    TransformerXLLayer as JaxLayer, _slice_pos_table, rel_shift as jax_rel_shift)
from transformer_transducer_tpu.ops.masks import (
    context_mask as jax_context_mask, look_ahead_mask as jax_look_ahead_mask)
from transformer_transducer_tpu.ops.pallas.banded_attention import (
    banded_attention as jax_banded)
from transformer_transducer_tpu.ops.pallas.flash_rel_attention import (
    flash_rel_attention as jax_flash)
from transformer_transducer_tpu_torch.models.attention import (
    TransformerXLLayer, rel_attention_dense, rel_shift, slice_pos_table)
from transformer_transducer_tpu_torch.ops.cuda import common
from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
    banded_attention, banded_attention_plain)
from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
    flash_rel_attention, flash_rel_attention_plain)
from transformer_transducer_tpu_torch.ops.masks import context_mask, look_ahead_mask

from torch_port_helpers import TOL, t

torch.set_num_threads(1)

B, H, DH = 2, 4, 16
T_VALUES = [1, 37, 129, 150]
BANDS = [(10, 2), (0, 0), (64, 64), (3, 64)]


def _inputs(tlen, seed, k_len=None):
    """q, k, v (B, T, H, Dh) and tables of ``k_len`` rows (default T)."""
    rng = np.random.RandomState(seed)
    k_len = k_len or tlen
    mk = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)
    return (mk(B, tlen, H, DH), mk(B, tlen, H, DH), mk(B, tlen, H, DH),
            mk(k_len, H, DH), mk(H, DH), mk(k_len, H))


def _jax_dense(q, k, v, re, u, rb, mask):
    """The JAX module's dense branch (models/attention.py:135-157)."""
    ac = jnp.einsum("bind,bjnd->bnij", q + u[None, None], k)
    bd = jax_rel_shift(jnp.einsum("bind,jnd->bnij", q, re)
                       + rb.T[None, :, None, :])
    score = (ac + bd) * (1.0 / DH ** 0.5)
    if mask is not None:
        score = jnp.where(mask[None, None], jnp.finfo(jnp.float32).min, score)
    return jnp.einsum("bnij,bjnd->bind", jax.nn.softmax(score, -1), v)


@pytest.mark.parametrize("tlen", T_VALUES)
@pytest.mark.parametrize("left,right", BANDS)
def test_banded_plain_matches_jax(tlen, left, right):
    args = _inputs(tlen, seed=tlen + 7 * left + right)
    got = banded_attention_plain(*map(t, args), left, right).numpy()
    jargs = list(map(jnp.asarray, args))
    dense = np.asarray(_jax_dense(*jargs, jax_context_mask(tlen, left, right)))
    np.testing.assert_allclose(got, dense, **TOL)
    kernel = np.asarray(jax_banded(*jargs, left, right, interpret=True))
    np.testing.assert_allclose(got, kernel, **TOL)


@pytest.mark.parametrize("tlen", T_VALUES)
def test_flash_plain_matches_jax(tlen):
    args = _inputs(tlen, seed=100 + tlen)
    got = flash_rel_attention_plain(*map(t, args)).numpy()
    jargs = list(map(jnp.asarray, args))
    np.testing.assert_allclose(got, np.asarray(_jax_dense(*jargs, None)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_flash(*jargs, True)), **TOL)


def test_banded_front_padded_tables_match_jax():
    """T > k_len: the tables are front-padded with row 0 before the kernel."""
    tlen, k_len = 150, 100
    q, k, v, re_full, u, rb_full = _inputs(tlen, seed=3, k_len=k_len)
    re = slice_pos_table(t(re_full), tlen)
    rb = slice_pos_table(t(rb_full), tlen)
    np.testing.assert_array_equal(
        re.numpy(), np.asarray(_slice_pos_table(jnp.asarray(re_full), tlen)))
    got = banded_attention(t(q), t(k), t(v), re, t(u), rb, 10, 2).numpy()
    ref = jax_banded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     _slice_pos_table(jnp.asarray(re_full), tlen),
                     jnp.asarray(u), _slice_pos_table(jnp.asarray(rb_full), tlen),
                     10, 2, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_wrappers_take_plain_version_on_cpu():
    args = list(map(t, _inputs(37, seed=5)))
    banded_attention.launches = 0
    flash_rel_attention.launches = 0
    np.testing.assert_array_equal(
        banded_attention(*args, 10, 2).numpy(),
        banded_attention_plain(*args, 10, 2).numpy())
    np.testing.assert_array_equal(flash_rel_attention(*args).numpy(),
                                  flash_rel_attention_plain(*args).numpy())
    assert banded_attention.launches == 0
    assert flash_rel_attention.launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, re, u, rb = map(t, _inputs(37, seed=6))
    with pytest.raises(ValueError):
        banded_attention(q, k, v, re, u, rb, 65, 2)
    with pytest.raises(ValueError):
        banded_attention(q, k, v, re, u, rb, 10, -1)
    with pytest.raises(TypeError):
        flash_rel_attention(q.double(), k, v, re, u, rb)
    with pytest.raises(ValueError):
        flash_rel_attention(q, k, v, re[:-1], u, rb)
    with pytest.raises(ValueError):   # the kernel route wants CUDA tensors
        common.kernel_args(q, k, v, re, u, rb)
    # packed heads and a row stride that is a multiple of 4: strided views of
    # a fused projection pass, transposed heads do not
    qkv = torch.zeros(B, 37, 3, H, DH)
    assert common.row_stride(qkv[:, :, 1], "k") == 3 * H * DH
    with pytest.raises(ValueError):
        common.row_stride(q.transpose(2, 3).reshape(B, 37, H, DH)
                          .transpose(2, 3), "q")


@pytest.mark.parametrize("qlen", [1, 5, 37])
def test_rel_shift_matches_jax(qlen):
    x = np.random.RandomState(qlen).randn(2, 3, qlen, qlen).astype(np.float32)
    np.testing.assert_array_equal(rel_shift(t(x)).numpy(),
                                  np.asarray(jax_rel_shift(jnp.asarray(x))))


def _layer_state(params):
    """A JAX layer's params as the port layer's state_dict."""
    from transformer_transducer_tpu_torch.utils.convert import _layer_state
    return _layer_state(params, "")


@pytest.mark.parametrize("mask_kind", ["none", "look_ahead", "context"])
@pytest.mark.parametrize("tlen", [37, 150])
def test_transformer_xl_layer_matches_jax(mask_kind, tlen):
    k_len, d_model = 120, 64
    jlayer = JaxLayer(k_len=k_len, n_head=H, d_model=d_model, d_head=DH,
                      d_inner=128)
    x = np.random.RandomState(tlen).randn(B, tlen, d_model).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jlayer.init(jax.random.PRNGKey(tlen), jnp.asarray(x)))["params"]
    layer = TransformerXLLayer(k_len, H, d_model, DH, 128).eval()
    layer.load_state_dict(_layer_state(params))
    jmask, mask = {"none": (None, None),
                   "look_ahead": (jax_look_ahead_mask(tlen), look_ahead_mask(tlen)),
                   "context": (jax_context_mask(tlen, 10, 2),
                               context_mask(tlen, 10, 2))}[mask_kind]
    ref = np.asarray(jlayer.apply({"params": params}, jnp.asarray(x), jmask))
    with torch.no_grad():
        got = layer(t(x), mask).numpy()
        banded = layer(t(x), band=(10, 2)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    if mask_kind == "context":
        np.testing.assert_allclose(banded, ref, **TOL)


def test_dense_branch_takes_batched_masks():
    q, k, v, re, u, rb = map(t, _inputs(20, seed=9))
    mask = context_mask(20, 3, 1)
    np.testing.assert_array_equal(
        rel_attention_dense(q, k, v, re, u, rb, mask).numpy(),
        rel_attention_dense(q, k, v, re, u, rb, mask.expand(B, 20, 20)).numpy())
