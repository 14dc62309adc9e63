"""PyTorch port: the RNN-T loss and its lattice sweeps held against the JAX
package (``ops/rnnt_loss.py``, the Pallas sweeps in interpret mode, and the
numpy oracle ``ops/rnnt_loss_np.py``).  fp32, tolerance ``TOL`` (rtol 2e-4,
atol 2e-5) unless a test says otherwise."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from transformer_transducer_tpu.ops import rnnt_loss as J
from transformer_transducer_tpu.ops.pallas.rnnt_kernel import (
    alpha_scan_pallas, beta_scan_pallas)
from transformer_transducer_tpu.ops.rnnt_loss_np import rnnt_loss_batch
from transformer_transducer_tpu_torch.ops import rnnt_loss as P
from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import (
    alpha_scan, alpha_scan_plain, beta_scan, beta_scan_plain)

from torch_port_helpers import TOL, jax_model, port_model, t, tiny_model_cfg

torch.set_num_threads(1)

SHAPES = [(1, 1, 0), (3, 12, 5), (2, 37, 9)]


def _grids(b, tlen, u, seed):
    rng = np.random.RandomState(seed)
    mk = lambda: (-np.abs(rng.randn(b, tlen, u + 1)) * 2).astype(np.float32)
    return mk(), mk()


def _lengths(b, tlen, u, seed):
    """Full rows, then shorter ones (at least 1 frame)."""
    rng = np.random.RandomState(seed)
    t_len = np.array([tlen] + list(rng.randint(1, tlen + 1, b - 1)))
    u_len = np.array([u] + list(rng.randint(0, u + 1, b - 1)))
    return t_len, u_len


def _skewed(lp_b, lp_l, u_len):
    sb = J._skew(jnp.asarray(lp_b))
    sl = J._skew(J._mask_label_grid(jnp.asarray(lp_l), jnp.asarray(u_len)))
    return sb, sl


@pytest.mark.parametrize("b,tlen,u", SHAPES)
def test_skew_and_unskew_match_jax(b, tlen, u):
    lp, _ = _grids(b, tlen, u, seed=tlen)
    got = P._skew(t(lp))
    want = np.asarray(J._skew(jnp.asarray(lp)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(P._unskew(t(want), tlen).numpy(),
                                  np.asarray(J._unskew(jnp.asarray(want), tlen)))


@pytest.mark.parametrize("b,tlen,u", SHAPES)
def test_plain_sweeps_match_jax_scans_and_pallas(b, tlen, u):
    lp_b, lp_l = _grids(b, tlen, u, seed=100 + tlen)
    t_len, u_len = _lengths(b, tlen, u, seed=tlen)
    sb, sl = _skewed(lp_b, lp_l, u_len)
    alpha = alpha_scan_plain(t(np.asarray(sb)), t(np.asarray(sl))).numpy()
    np.testing.assert_allclose(alpha, np.asarray(J._alpha_scan(sb, sl)), **TOL)
    np.testing.assert_allclose(
        alpha, np.asarray(alpha_scan_pallas(sb, sl, interpret=True)), **TOL)

    d_total, u1 = sb.shape[1], sb.shape[2]
    d_final = t_len - 1 + u_len
    terminal = ((np.arange(d_total)[None, :, None] == d_final[:, None, None])
                & (np.arange(u1)[None, None, :] == u_len[:, None, None]))
    inject = jnp.where(terminal, sb, J.NEG)
    beta = beta_scan_plain(t(np.asarray(sb)), t(np.asarray(sl)),
                           t(np.asarray(inject))).numpy()
    np.testing.assert_allclose(beta, np.asarray(J._beta_scan(sb, sl, terminal)),
                               **TOL)
    np.testing.assert_allclose(
        beta, np.asarray(beta_scan_pallas(sb, sl, inject, interpret=True)), **TOL)


def test_loss_grid_and_gradients_match_jax_on_edge_rows():
    """Rows with t_len == 0, u_len == 0, u_len == U, and over-length
    lengths (clamped to the grid)."""
    b, tlen, u = 6, 12, 5
    lp_b, lp_l = _grids(b, tlen, u, seed=7)
    t_len = np.array([12, 0, 7, 12, 20, 3])
    u_len = np.array([5, 2, 0, 5, 9, 1])

    def jax_loss(a, c):
        return J.rnnt_loss_grid(a, c, jnp.asarray(t_len), jnp.asarray(u_len))

    want = np.asarray(jax_loss(jnp.asarray(lp_b), jnp.asarray(lp_l)))
    w = np.linspace(0.5, 1.5, b).astype(np.float32)    # distinct row weights
    g_b, g_l = jax.grad(lambda a, c: jnp.sum(jax_loss(a, c) * w), argnums=(0, 1))(
        jnp.asarray(lp_b), jnp.asarray(lp_l))

    a = t(lp_b).requires_grad_()
    c = t(lp_l).requires_grad_()
    got = P.rnnt_loss_grid(a, c, t(t_len), t(u_len))
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert got[1].item() == 0.0
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g_b), **TOL)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(g_l), **TOL)
    assert not a.grad[1].any() and not c.grad[1].any()


def test_loss_from_logits_matches_numpy_oracle():
    rng = np.random.RandomState(3)
    b, tlen, u, v = 3, 9, 4, 7
    logits = rng.randn(b, tlen, u + 1, v).astype(np.float32)
    labels = rng.randint(1, v, (b, u))
    t_len, u_len = np.array([9, 6, 4]), np.array([4, 2, 0])
    want, grads = rnnt_loss_batch(logits, labels, t_len, u_len)
    x = t(logits).requires_grad_()
    got = P.rnnt_loss(x, t(labels), t(t_len), t(u_len), reduction="none")
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(x.grad.numpy(), grads, **TOL)
    mean = P.rnnt_loss(t(logits), t(labels), t(t_len), t(u_len))
    np.testing.assert_allclose(mean.item(), want.mean(), **TOL)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("tied", [False, True])
def test_fused_loss_and_gradients_match_jax(remat, tied):
    """Gradients with respect to enc, dec and every joint weight; a chunk
    size (5) that does not divide T (13)."""
    cfg = tiny_model_cfg(vocab=30, share_embedding=tied)
    model_j, variables = jax_model(cfg, seed=1)
    model = port_model(cfg, variables)
    rng = np.random.RandomState(5)
    b, tlen, u = 3, 13, 4
    enc = rng.randn(b, tlen, 64).astype(np.float32)
    dec = rng.randn(b, u + 1, 64).astype(np.float32)
    labels = rng.randint(1, 30, (b, u))
    t_len, u_len = np.array([13, 9, 5]), np.array([4, 3, 1])

    jp = J.joint_params_from_variables(variables)
    args = (jnp.asarray(labels), jnp.asarray(t_len), jnp.asarray(u_len))
    loss_j, grads_j = jax.value_and_grad(
        lambda e, d, p: J.rnnt_loss_fused(e, d, p, *args, chunk_size=5,
                                          remat=remat),
        argnums=(0, 1, 2))(jnp.asarray(enc), jnp.asarray(dec),
                           tuple(map(jnp.asarray, jp)))

    e, d = t(enc).requires_grad_(), t(dec).requires_grad_()
    jp_t = P.joint_params(model)
    for mine, theirs in zip(jp_t, jp):
        np.testing.assert_array_equal(mine.detach().numpy(), np.asarray(theirs))
    loss = P.rnnt_loss_fused(e, d, jp_t, t(labels), t(t_len), t(u_len),
                             chunk_size=5, remat=remat)
    grads = torch.autograd.grad(loss, [e, d, *jp_t])
    np.testing.assert_allclose(loss.item(), float(loss_j), **TOL)
    want = [grads_j[0], grads_j[1], *grads_j[2]]
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_cpu_calls_launch_no_kernel():
    alpha_scan.launches = beta_scan.launches = 0
    lp_b, lp_l = _grids(2, 6, 3, seed=1)
    a = t(lp_b).requires_grad_()
    P.rnnt_loss_grid(a, t(lp_l), t(np.array([6, 4])), t(np.array([3, 2]))).sum().backward()
    sb = P._skew(t(lp_b)).contiguous()
    assert torch.equal(alpha_scan(sb, sb), alpha_scan_plain(sb, sb))
    assert alpha_scan.launches == 0 and beta_scan.launches == 0
    with pytest.raises(ValueError, match="one .B, D, U1. shape"):
        alpha_scan(sb, sb[:, 1:])
