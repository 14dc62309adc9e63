"""PyTorch port: the pruned RNN-T loss held against the JAX package
(``ops/rnnt_loss_pruned.py``, and its Pallas kernels in interpret mode:
``_logz_pallas``, ``band_alpha_pallas``, ``band_beta_pallas``,
``rnnt_loss_banded_pallas``).  Inputs are made with numpy from seeds; on the
CPU the port's kernels take their plain versions.  fp32, tolerance ``TOL``
(rtol 2e-4, atol 2e-5) unless a test says otherwise.

Band sweeps: cells that no path reaches hold values at or below NEG (-1e30)
whose exact size depends on how many NEG terms were added on the way (the
Pallas kernel, the oracle and the port differ there); they are compared
after clamping at NEG, every reachable cell as it is."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from transformer_transducer_tpu.ops import rnnt_loss_pruned as J
from transformer_transducer_tpu.ops.pallas.band_kernel import (
    band_alpha_pallas, band_beta_pallas)
from transformer_transducer_tpu.ops.pallas.logz_kernel import (
    _logz_pallas, additive_logz as jax_additive_logz, additive_logz_xla)
from transformer_transducer_tpu.ops.rnnt_loss import rnnt_loss_fused as jax_fused
from transformer_transducer_tpu_torch.ops import rnnt_loss_pruned as P
from transformer_transducer_tpu_torch.ops.cuda.band_kernel import (
    band_alpha, band_alpha_plain, band_beta, band_beta_plain)
from transformer_transducer_tpu_torch.ops.cuda.logz_kernel import (
    additive_logz, additive_logz_plain)
from transformer_transducer_tpu_torch.ops.rnnt_loss import rnnt_loss_fused

from torch_port_helpers import TOL, t

torch.set_num_threads(1)

NEG = -1e30
BAND_SHAPES = [(2, 17, 9, 5), (3, 40, 20, 5), (1, 8, 3, 3), (4, 25, 12, 7),
               (2, 12, 40, 5)]


def _problem(seed=0, b=3, tlen=11, u=4, v=7, inner=6, d=5):
    """Encoder / label-encoder states, joint weights (W_enc, W_dec, b1,
    W_out, b_out), labels and lengths, as numpy (the JAX tests' shapes)."""
    rng = np.random.RandomState(seed)
    enc = rng.randn(b, tlen, d).astype(np.float32)
    dec = rng.randn(b, u + 1, d).astype(np.float32)
    jp = [(rng.randn(*s) * 0.5).astype(np.float32)
          for s in [(d, inner), (d, inner), (inner,), (inner, v), (v,)]]
    labels = rng.randint(1, v, (b, u)).astype(np.int32)
    t_len = np.array([tlen, tlen - 2, tlen - 5])[:b]
    u_len = np.array([u, u - 1, u - 2])[:b]
    return enc, dec, jp, labels, t_len, u_len


def _band_problem(seed, b, tlen, u, s_range):
    """Band grids and monotone band starts with the ``bounds_from_occ``
    invariants (the JAX tests' ``_band_problem``), as numpy."""
    r = np.random.RandomState(seed)
    lp_b = np.log(r.uniform(0.05, 1.0, (b, tlen, s_range))).astype(np.float32)
    lp_l = np.log(r.uniform(0.05, 1.0, (b, tlen, s_range))).astype(np.float32)
    t_len = r.randint(max(1, tlen // 2), tlen + 1, (b,)).astype(np.int32)
    u_len = r.randint(1, u + 1, (b,)).astype(np.int32)
    steps = r.randint(0, s_range, (b, tlen - 1))
    rs = np.concatenate([np.zeros((b, 1), np.int64), np.cumsum(steps, axis=1)], axis=1)
    rs = np.minimum(rs, np.maximum(u_len[:, None] - s_range + 1, 0)).astype(np.int32)
    uidx = rs[:, :, None] + np.arange(s_range)[None, None, :]
    lp_l = np.where(uidx < u_len[:, None, None], lp_l, NEG).astype(np.float32)
    return lp_b, lp_l, rs, t_len, u_len


def _steps(rs):
    return np.diff(rs, axis=1).astype(np.int32)


def _close_clamped(got, want, **tol):
    np.testing.assert_allclose(np.maximum(np.asarray(got), NEG),
                               np.maximum(np.asarray(want), NEG), **tol)


# ---------------------------------------------------------------------------
# Kernel 3: the additive logZ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,tlen,u1,v", [(2, 19, 6, 37), (1, 1, 1, 5), (3, 40, 9, 130)])
def test_additive_logz_plain_matches_pallas_and_xla(b, tlen, u1, v):
    rng = np.random.RandomState(tlen)
    a = (rng.randn(b, tlen, v) * 3).astype(np.float32)
    l = (rng.randn(b, u1, v) * 3).astype(np.float32)
    got = additive_logz_plain(t(a), t(l)).numpy()
    assert got.shape == (b, tlen, u1)
    np.testing.assert_allclose(got, np.asarray(additive_logz_xla(jnp.asarray(a),
                                                                 jnp.asarray(l))), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(_logz_pallas(jnp.asarray(a), jnp.asarray(l), interpret=True)),
        **TOL)


def test_additive_logz_gradients_match_jax_custom_vjp():
    rng = np.random.RandomState(1)
    a = rng.randn(2, 7, 13).astype(np.float32)
    l = rng.randn(2, 4, 13).astype(np.float32)
    w = rng.randn(2, 7, 4).astype(np.float32)
    ga, gl = jax.grad(lambda x, y: jnp.sum(jax_additive_logz(x, y) * w),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(l))
    x, y = t(a).requires_grad_(), t(l).requires_grad_()
    z = additive_logz(x, y)
    (z * t(w)).sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), additive_logz_plain(t(a), t(l)).numpy())
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ga), **TOL)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(gl), **TOL)


# ---------------------------------------------------------------------------
# Kernels 4-5: the band sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", BAND_SHAPES)
def test_band_sweeps_plain_match_pallas(shape):
    b, tlen, u, s_range = shape
    lp_b, lp_l, rs, t_len, u_len = _band_problem(0, *shape)
    d_alpha = np.pad(_steps(rs), ((0, 0), (1, 0)))
    d_beta = np.pad(_steps(rs), ((0, 0), (0, 1)))
    _, tf, sf = J._band_terminal(jnp.asarray(lp_b), jnp.asarray(rs),
                                 jnp.asarray(t_len), jnp.asarray(u_len))
    tf, sf = np.asarray(tf), np.asarray(sf)

    alpha = band_alpha(t(lp_b), t(lp_l), t(d_alpha), s_range)
    assert torch.equal(alpha, band_alpha_plain(t(lp_b), t(lp_l), t(d_alpha)))
    _close_clamped(alpha, band_alpha_pallas(jnp.asarray(lp_b), jnp.asarray(lp_l),
                                            jnp.asarray(d_alpha), s_range, True), **TOL)
    beta = band_beta(t(lp_b), t(lp_l), t(d_beta), t(tf), t(sf), s_range)
    assert torch.equal(beta, band_beta_plain(t(lp_b), t(lp_l), t(d_beta), t(tf), t(sf)))
    _close_clamped(beta, band_beta_pallas(jnp.asarray(lp_b), jnp.asarray(lp_l),
                                          jnp.asarray(d_beta), jnp.asarray(tf),
                                          jnp.asarray(sf), s_range, True), **TOL)
    # the two sweeps agree on each sequence's total
    bi = np.arange(b)
    np.testing.assert_allclose(alpha.numpy()[bi, tf, sf] + lp_b[bi, tf, sf],
                               beta.numpy()[:, 0, 0], rtol=1e-5, atol=1e-4)


def test_out_of_range_shift_means_no_in_band_source():
    """A band shift outside [0, S) brings NEG along the blank edge, as in
    the Pallas kernels (and unlike the oracle's guarded gather for d < 0)."""
    lp_b, lp_l, rs, t_len, u_len = _band_problem(4, 2, 12, 9, 4)
    d = np.pad(_steps(rs), ((0, 0), (1, 0)))
    d[0, 5], d[1, 3], d[1, 8] = -1, 4, 7
    tf = np.minimum(t_len, 12) - 1
    sf = np.array([1, 3], np.int32)
    _close_clamped(band_alpha(t(lp_b), t(lp_l), t(d), 4),
                   band_alpha_pallas(jnp.asarray(lp_b), jnp.asarray(lp_l),
                                     jnp.asarray(d), 4, True), **TOL)
    _close_clamped(band_beta(t(lp_b), t(lp_l), t(d), t(tf), t(sf), 4),
                   band_beta_pallas(jnp.asarray(lp_b), jnp.asarray(lp_l),
                                    jnp.asarray(d), jnp.asarray(tf),
                                    jnp.asarray(sf), 4, True), **TOL)
    # the row after the bad shift starts from NEG except along the label chain
    assert (band_alpha(t(lp_b), t(lp_l), t(d), 4)[0, 5, 0] <= NEG).item()


@pytest.mark.parametrize("shape", BAND_SHAPES)
def test_banded_loss_and_gradients_match_pallas_and_oracle(shape):
    lp_b, lp_l, rs, t_len, u_len = _band_problem(0, *shape)
    w = np.linspace(0.5, 1.5, shape[0]).astype(np.float32)
    args = tuple(map(jnp.asarray, (rs, t_len, u_len)))
    want = {}
    for name, fn in (("pallas", lambda a, c: J.rnnt_loss_banded_pallas(a, c, *args, True)),
                     ("oracle", lambda a, c: J.rnnt_loss_banded_grid(a, c, *args))):
        loss = fn(jnp.asarray(lp_b), jnp.asarray(lp_l))
        grads = jax.grad(lambda a, c: jnp.sum(fn(a, c) * w), argnums=(0, 1))(
            jnp.asarray(lp_b), jnp.asarray(lp_l))
        want[name] = (np.asarray(loss), *map(np.asarray, grads))

    a, c = t(lp_b).requires_grad_(), t(lp_l).requires_grad_()
    loss = P.rnnt_loss_banded(a, c, t(rs), t(t_len), t(u_len))
    (loss * t(w)).sum().backward()
    got = (loss.detach().numpy(), a.grad.numpy(), c.grad.numpy())
    for g, ref in zip(got, want["pallas"]):
        np.testing.assert_allclose(g, ref, **TOL)
    # the analytic backward against autodiff through the oracle's scan, at
    # the JAX package's own tolerances for that comparison
    np.testing.assert_allclose(got[0], want["oracle"][0], rtol=1e-5, atol=1e-5)
    for g, ref in zip(got[1:], want["oracle"][1:]):
        np.testing.assert_allclose(g, ref, rtol=1e-3, atol=5e-4)


def test_banded_loss_zero_length_rows():
    lp_b, lp_l, rs, _, u_len = _band_problem(3, 2, 10, 5, 5)
    t_len = np.array([0, 7], np.int32)
    want = J.rnnt_loss_banded_pallas(jnp.asarray(lp_b), jnp.asarray(lp_l),
                                     jnp.asarray(rs), jnp.asarray(t_len),
                                     jnp.asarray(u_len), True)
    a, c = t(lp_b).requires_grad_(), t(lp_l).requires_grad_()
    loss = P.rnnt_loss_banded(a, c, t(rs), t(t_len), t(u_len))
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want), **TOL)
    assert loss[0].item() == 0.0
    assert not a.grad[0].any() and not c.grad[0].any()
    assert torch.isfinite(a.grad).all() and torch.isfinite(c.grad).all()
    oracle = P.rnnt_loss_banded_grid(t(lp_b), t(lp_l), t(rs), t(t_len), t(u_len))
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", BAND_SHAPES[:3])
def test_banded_oracle_matches_jax_oracle(shape):
    lp_b, lp_l, rs, t_len, u_len = _band_problem(2, *shape)
    args = tuple(map(jnp.asarray, (rs, t_len, u_len)))
    want, (g_b, g_l) = jax.value_and_grad(
        lambda a, c: jnp.sum(J.rnnt_loss_banded_grid(a, c, *args)), argnums=(0, 1))(
        jnp.asarray(lp_b), jnp.asarray(lp_l))
    a, c = t(lp_b).requires_grad_(), t(lp_l).requires_grad_()
    loss = P.rnnt_loss_banded_grid(a, c, t(rs), t(t_len), t(u_len)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g_b), **TOL)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(g_l), **TOL)


# ---------------------------------------------------------------------------
# Stages 1-3 against JAX
# ---------------------------------------------------------------------------

def _jax_simple(enc, dec, jp, labels, t_len, u_len, s_range):
    """JAX's simple grids, (losses, occ) and band starts, as numpy."""
    sp_b, sp_l = J.simple_grid_logprobs(jnp.asarray(enc), jnp.asarray(dec),
                                        tuple(map(jnp.asarray, jp)), jnp.asarray(labels))
    losses, occ = J.simple_loss_and_occ(sp_b, sp_l, jnp.asarray(t_len),
                                        jnp.asarray(u_len))
    rs = J.bounds_from_occ(occ, jnp.asarray(t_len), jnp.asarray(u_len), s_range)
    return tuple(map(np.asarray, (sp_b, sp_l, losses, occ, rs)))


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_simple_stage_and_bounds_match_jax(seed):
    enc, dec, jp, labels, t_len, u_len = _problem(seed=seed)
    sp_b, sp_l = P.simple_grid_logprobs(t(enc), t(dec), list(map(t, jp)), t(labels))
    for s_range in (2, 3, 5):
        jb, jl, j_losses, j_occ, j_rs = _jax_simple(enc, dec, jp, labels, t_len,
                                                    u_len, s_range)
        np.testing.assert_allclose(sp_b.numpy(), jb, **TOL)
        np.testing.assert_allclose(sp_l.numpy(), jl, **TOL)
        losses, occ = P.simple_loss_and_occ(sp_b, sp_l, t(t_len), t(u_len))
        np.testing.assert_allclose(losses.numpy(), j_losses, **TOL)
        np.testing.assert_allclose(occ.numpy(), j_occ, **TOL)
        # equal integers, from JAX's occupancies and from the port's own
        rs = P.bounds_from_occ(t(j_occ), t(t_len), t(u_len), s_range)
        np.testing.assert_array_equal(rs.numpy(), j_rs)
        np.testing.assert_array_equal(
            P.pruned_bounds(sp_b, sp_l, t(t_len), t(u_len), s_range).numpy(), j_rs)


def test_simple_loss_gradient_is_the_saved_occupancy():
    """The loss output's gradient equals ``rnnt_loss_grid``'s, and the
    occupancy output carries none."""
    rng = np.random.RandomState(2)
    pb, pl = (rng.randn(3, 8, 5).astype(np.float32) for _ in range(2))
    t_len, u_len = np.array([8, 7, 6]), np.array([4, 3, 1])
    w = rng.randn(3).astype(np.float32)
    g_want = jax.grad(lambda a: jnp.sum(J.simple_loss_and_occ(
        a, jnp.asarray(pl), jnp.asarray(t_len), jnp.asarray(u_len))[0] * w))(
        jnp.asarray(pb))
    a = t(pb).requires_grad_()
    losses, occ = P.simple_loss_and_occ(a, t(pl), t(t_len), t(u_len))
    assert not occ.requires_grad
    (losses * t(w)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g_want), **TOL)


@pytest.mark.parametrize("activation", ["tanh", "relu"])
@pytest.mark.parametrize("remat", [True, False])
def test_banded_grids_match_jax_on_jax_bounds(activation, remat):
    enc, dec, jp, labels, t_len, u_len = _problem(seed=5)
    *_, rs = _jax_simple(enc, dec, jp, labels, t_len, u_len, 3)
    want = J.banded_grid_logprobs(jnp.asarray(enc), jnp.asarray(dec),
                                  tuple(map(jnp.asarray, jp)), jnp.asarray(labels),
                                  jnp.asarray(rs), jnp.asarray(u_len), 3,
                                  chunk_size=4, remat=remat, activation=activation)
    got = P.banded_grid_logprobs(t(enc), t(dec), list(map(t, jp)), t(labels), t(rs),
                                 t(u_len), 3, chunk_size=4, remat=remat,
                                 activation=activation)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("activation", ["tanh", "relu"])
@pytest.mark.parametrize("simple_scale", [0.0, 0.25])
@pytest.mark.parametrize("s_range", [2, 3, 5])
def test_pruned_loss_and_gradients_match_jax(s_range, simple_scale, activation):
    """Loss and gradients in enc, dec and the five joint tensors; the band
    starts of both sides are equal integers at this seed."""
    enc, dec, jp, labels, t_len, u_len = _problem(seed=s_range)
    *_, j_rs = _jax_simple(enc, dec, jp, labels, t_len, u_len, s_range)
    sp_b, sp_l = P.simple_grid_logprobs(t(enc), t(dec), list(map(t, jp)), t(labels))
    np.testing.assert_array_equal(
        P.pruned_bounds(sp_b, sp_l, t(t_len), t(u_len), s_range).numpy(), j_rs)

    kw = dict(s_range=s_range, chunk_size=4, activation=activation,
              simple_scale=simple_scale)
    loss_j, grads_j = jax.value_and_grad(
        lambda e, d, p: J.rnnt_loss_pruned(e, d, p, jnp.asarray(labels),
                                           jnp.asarray(t_len), jnp.asarray(u_len), **kw),
        argnums=(0, 1, 2))(jnp.asarray(enc), jnp.asarray(dec), tuple(map(jnp.asarray, jp)))
    leaves = [t(x).requires_grad_() for x in (enc, dec, *jp)]
    loss = P.rnnt_loss_pruned(leaves[0], leaves[1], leaves[2:], t(labels), t(t_len),
                              t(u_len), **kw)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(loss_j), **TOL)
    for got, want in zip(grads, [grads_j[0], grads_j[1], *grads_j[2]]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Properties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("simple_scale", [0.0, 0.25])
def test_unpruned_limit_equals_the_fused_loss(simple_scale):
    """s_range = U+1 covers the grid: loss and gradients equal the port's
    ``rnnt_loss_fused`` (plus the simple term when it is on)."""
    enc, dec, jp, labels, t_len, u_len = _problem()
    leaves = [t(x).requires_grad_() for x in (enc, dec, *jp)]
    args = (leaves[0], leaves[1], leaves[2:], t(labels), t(t_len), t(u_len))
    full = rnnt_loss_fused(*args, chunk_size=4)
    if simple_scale:
        sp_b, sp_l = P.simple_grid_logprobs(*args[:4])
        full = full + simple_scale * P.simple_loss_and_occ(
            sp_b, sp_l, t(t_len), t(u_len))[0].mean()
    pruned = P.rnnt_loss_pruned(*args, s_range=dec.shape[1], chunk_size=4,
                                simple_scale=simple_scale)
    np.testing.assert_allclose(pruned.item(), full.item(), rtol=1e-5)
    for a, b in zip(torch.autograd.grad(pruned, leaves), torch.autograd.grad(full, leaves)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [2, 7])
def test_narrow_band_upper_bounds_the_full_nll(seed):
    enc, dec, jp, labels, t_len, u_len = _problem(seed=seed)
    args = (t(enc), t(dec), list(map(t, jp)), t(labels), t(t_len), t(u_len))
    full = rnnt_loss_fused(*args, chunk_size=4, reduction="none")
    for s_range in (2, 3):
        pruned = P.rnnt_loss_pruned(*args, s_range=s_range, chunk_size=4,
                                    reduction="none")
        assert (pruned >= full - 1e-4).all(), (s_range, pruned, full)


def test_infeasible_corridor_truncates_with_live_gradients():
    enc, dec, jp, labels, _, _ = _problem(seed=6, tlen=3, u=4)
    t_len, u_len = np.array([3, 2, 2]), np.array([4, 4, 3])
    leaves = [t(enc).requires_grad_()] + [t(x).requires_grad_() for x in jp]
    losses = P.rnnt_loss_pruned(leaves[0], t(dec), leaves[1:], t(labels), t(t_len),
                                t(u_len), s_range=2, chunk_size=4, reduction="none")
    want = J.rnnt_loss_pruned(jnp.asarray(enc), jnp.asarray(dec),
                              tuple(map(jnp.asarray, jp)), jnp.asarray(labels),
                              jnp.asarray(t_len), jnp.asarray(u_len), s_range=2,
                              chunk_size=4, reduction="none")
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(want), **TOL)
    assert torch.isfinite(losses).all() and (losses > 0).all()
    norm = sum(g.abs().sum() for g in torch.autograd.grad(losses.sum(), leaves))
    assert torch.isfinite(norm) and norm > 0


def test_unpruned_jax_limit_agrees_with_jax_fused():
    """The reference property on the JAX side at the seed used above, so the
    port's limit test and JAX's hold the same function."""
    enc, dec, jp, labels, t_len, u_len = _problem()
    args = (jnp.asarray(enc), jnp.asarray(dec), tuple(map(jnp.asarray, jp)),
            jnp.asarray(labels), jnp.asarray(t_len), jnp.asarray(u_len))
    got = P.rnnt_loss_pruned(t(enc), t(dec), list(map(t, jp)), t(labels), t(t_len),
                             t(u_len), s_range=dec.shape[1], chunk_size=4)
    np.testing.assert_allclose(got.item(), float(jax_fused(*args, chunk_size=4)), **TOL)


# ---------------------------------------------------------------------------
# Wrappers on the CPU
# ---------------------------------------------------------------------------

def test_cpu_calls_launch_no_kernel_and_wrappers_check_inputs():
    additive_logz.launches = band_alpha.launches = band_beta.launches = 0
    enc, dec, jp, labels, t_len, u_len = _problem(seed=1)
    leaves = [t(x).requires_grad_() for x in (enc, dec, *jp)]
    P.rnnt_loss_pruned(leaves[0], leaves[1], leaves[2:], t(labels), t(t_len),
                       t(u_len), s_range=3, chunk_size=4, simple_scale=0.25).backward()
    assert additive_logz.launches == band_alpha.launches == band_beta.launches == 0
    lp_b, lp_l, rs, _, _ = _band_problem(0, 2, 6, 4, 3)
    d = t(np.zeros((2, 6), np.int32))
    with pytest.raises(ValueError, match="S = 4"):
        band_alpha(t(lp_b), t(lp_l), d, 4)
    with pytest.raises(ValueError, match=r"d must be \(B, T\)"):
        band_alpha(t(lp_b), t(lp_l), d[:, 1:], 3)
    with pytest.raises(TypeError, match="float32"):
        band_beta(t(lp_b).double(), t(lp_l).double(), d, d[:, 0], d[:, 0], 3)
    with pytest.raises(ValueError, match=r"\(B, U1, V\)"):
        additive_logz(t(lp_b), t(lp_l)[:, :, :2])
