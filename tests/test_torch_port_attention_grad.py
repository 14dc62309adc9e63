"""PyTorch port: gradients of the rel-position attention paths held against
``jax.grad`` through the JAX package's Pallas kernels (interpret mode),
with respect to q, k, v, the un-sliced r_emb, r_w_bias and r_bias.  On the
CPU the port's flash and banded wrappers take their plain versions (autograd
through the dense branch), so no kernel launches here.  fp32, tolerance
``TOL`` (rtol 2e-4, atol 2e-5)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from transformer_transducer_tpu.models.attention import _slice_pos_table
from transformer_transducer_tpu.ops.pallas.banded_attention import (
    banded_attention as jax_banded)
from transformer_transducer_tpu.ops.pallas.flash_rel_attention import (
    flash_rel_attention as jax_flash)
from transformer_transducer_tpu_torch.models.attention import slice_pos_table
from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
    banded_attention, banded_attention_backward)
from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
    flash_rel_attention, flash_rel_attention_backward)

from torch_port_helpers import TOL, t

torch.set_num_threads(1)

B, H, DH, K_LEN = 2, 2, 16, 120
T_VALUES = [1, 37, 150]          # 150 > K_LEN: front-padded tables
BANDS = [(10, 2), (0, 0), (64, 64)]


def _inputs(tlen, seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)
    return (mk(B, tlen, H, DH), mk(B, tlen, H, DH), mk(B, tlen, H, DH),
            mk(K_LEN, H, DH), mk(H, DH), mk(K_LEN, H), mk(B, tlen, H, DH))


def _jax_grads(fn, args, g):
    def loss(q, k, v, re, u, rb):
        tlen = q.shape[1]
        out = fn(q, k, v, _slice_pos_table(re, tlen), u, _slice_pos_table(rb, tlen))
        return jnp.sum(out * g)
    return jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, args))


def _port_grads(fn, args, g):
    leaves = [t(x).requires_grad_() for x in args]
    q, k, v, re, u, rb = leaves
    tlen = q.shape[1]
    out = fn(q, k, v, slice_pos_table(re, tlen), u, slice_pos_table(rb, tlen))
    (out * t(g)).sum().backward()
    return [x.grad for x in leaves]


def _check(got, want):
    for name, a, b in zip(("q", "k", "v", "r_emb", "r_w_bias", "r_bias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("tlen", T_VALUES)
def test_flash_gradients_match_jax(tlen):
    *args, g = _inputs(tlen, seed=tlen)
    flash_rel_attention.launches = flash_rel_attention_backward.launches = 0
    got = _port_grads(flash_rel_attention, args, g)
    _check(got, _jax_grads(lambda *a: jax_flash(*a, True), args, g))
    assert flash_rel_attention.launches == flash_rel_attention_backward.launches == 0


@pytest.mark.parametrize("tlen", T_VALUES)
@pytest.mark.parametrize("left,right", BANDS)
def test_banded_gradients_match_jax(tlen, left, right):
    *args, g = _inputs(tlen, seed=3 * tlen + left + right)
    banded_attention.launches = banded_attention_backward.launches = 0
    got = _port_grads(lambda *a: banded_attention(*a, left, right), args, g)
    _check(got, _jax_grads(
        lambda *a: jax_banded(*a, left, right, interpret=True), args, g))
    assert banded_attention.launches == banded_attention_backward.launches == 0


def test_front_pad_rows_sum_into_table_row_zero():
    """T > k_len: the tables' front-pad rows are copies of row 0, so their
    gradients land in row 0 (autograd through ``slice_pos_table``)."""
    *args, g = _inputs(150, seed=11)
    got = _port_grads(flash_rel_attention, args, g)
    leaves = [t(x) for x in args]
    q, k, v, re, u, rb = leaves
    sliced = [slice_pos_table(re, 150).requires_grad_(),
              slice_pos_table(rb, 150).requires_grad_()]
    out = flash_rel_attention(q, k, v, sliced[0], u, sliced[1])
    (out * t(g)).sum().backward()
    pad = 150 - K_LEN
    for full, part in zip((got[3], got[5]), sliced):
        torch.testing.assert_close(full[0], part.grad[:pad + 1].sum(0), **TOL)
        torch.testing.assert_close(full[1:], part.grad[pad + 1:], **TOL)
