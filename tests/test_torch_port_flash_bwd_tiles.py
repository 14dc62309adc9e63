"""PyTorch port: the tile algebra of the flash rel-position attention
backward (``csrc/flash_rel_attention_bwd.cu``), proved on the CPU.

The CUDA kernel cannot run here, so this file emulates its schedule in plain
PyTorch: query tiles of TQ rows, key chunks of TK = 64, the chunk's NE = TQ +
TK - 1 table rows with the own/next split by column (q_i where the offset
o <= 0, q_{i+1} where o >= 1), the BD scores read along the diagonals of QE,
dS written into the same skew (DSk) and the three BD products taken from it.
The emulated gradients are held against autograd through the port's plain
version and against ``jax.grad`` through the JAX package's Pallas kernel in
interpret mode, on the same numpy inputs (fp32, ``TOL``: rtol 2e-4, atol
2e-5).

The bf16 form's schedule (``flash_bwd_tc<Dh, true>``) runs through the same
emulation with ``bf16=True``: q + u rounded to bf16, dO rounded to bf16,
the scores and dS divided by sqrt(Dh), D_i from the float32 P's product
with v (the forward's sums), P and dS rounded to bf16 before every product
(exact on bf16 values, so one TF32 pass), the gradients cast to bf16.  It
is held against the plain bf16 backward and ``jax.grad`` through the
Pallas kernels on bf16 inputs, each gradient within 2e-3 of its leaf's
largest magnitude or one bf16 step of the element (the final cast), plus
1e-5.

It also holds the kernel's 3xTF32 products to the card's tolerance (atol
1e-4 * max|ref| + 1e-5, rtol 1e-4): ``cvt.rna.tf32.f32`` is emulated on the
bits, the hi/lo split product accumulates in fp32 per 8-deep step as the
tensor core does, and a single TF32 product is shown to miss the tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.ops.pallas.flash_rel_attention import (
    flash_rel_attention as jax_flash)
from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
    flash_rel_attention_plain)

from torch_port_helpers import (
    TOL, bd_rows, bf16_step, gather_rows, hold_bf16, t, tc_product, tf32_rna)

torch.set_num_threads(1)

TK = 64
T_VALUES = [1, 15, 16, 17, 33, 64, 65, 150]
SHAPES = [(2, 2, 16), (1, 1, 64)]        # (B, H, Dh)


def _tile_chunks(tlen, tq):
    """(i0, j0, omin, table rows of the chunk's NX offsets, own columns)."""
    nx = tq + TK
    for i0 in range(0, tlen, tq):
        for j0 in range(0, tlen, TK):
            omin = j0 - (i0 + tq - 1)
            x = torch.arange(nx)
            rows = torch.where(x < tq + TK - 1, bd_rows(tlen, omin + x), -1)
            yield i0, j0, rows, x < 1 - omin


def emulate_flash_bwd(q, k, v, re, u, rb, dout, tq, bf16=False):
    """The kernel's schedule: q, k, v, dout (B, T, H, Dh); re (T, H, Dh), u
    (H, Dh), rb (T, H) sliced to T rows.  Returns (dq, dk, dv, d re, d u,
    d rb).  The forward's output and row log-sum-exp come from the same
    tiles.  ``bf16``: the bf16 form on float32 tensors holding bf16 values
    (the forward's output then the float32 P's sums)."""
    b, tlen, h, dh = q.shape
    scale = 1.0 / dh ** 0.5
    root = float(np.sqrt(dh))
    rnd = (lambda x: x.to(torch.bfloat16).float()) if bf16 else (lambda x: x)
    dout, qu_all = rnd(dout), rnd(q + u)
    div = (lambda x: x / root) if bf16 else (lambda x: x * scale)
    qh, kh, vh, gh = (x.transpose(1, 2) for x in (q, k, v, dout))   # (B, H, T, Dh)
    pad = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, n))
    qp, kp, vp, gp = pad(qh, tq + 1), pad(kh, TK), pad(vh, TK), pad(gh, tq)
    qup = pad(qu_all.transpose(1, 2), tq)
    r_idx = torch.arange(tq)[:, None]
    kk_idx = torch.arange(TK)[None, :]

    def tile_scores(i0, j0, rows, own):
        qt, qn = qp[:, :, i0:i0 + tq], qp[:, :, i0 + 1:i0 + tq + 1]
        e = gather_rows(re, rows).transpose(0, 1)                   # (H, NX, Dh)
        eb = gather_rows(rb, rows).t()[None, :, None, :]            # (1, H, 1, NX)
        qe = torch.where(own, qt @ e.transpose(-1, -2), qn @ e.transpose(-1, -2)) + eb
        bd = qe[:, :, r_idx, kk_idx - r_idx + tq - 1]               # diagonal read
        s_ac = qup[:, :, i0:i0 + tq] @ kp[:, :, j0:j0 + TK].transpose(-1, -2)
        live = ((i0 + r_idx) < tlen) & ((j0 + kk_idx) < tlen)
        return div(s_ac + bd), live, qt, qn, e

    # the forward on the same tiles: row log-sum-exp and output
    lse = torch.full((b, h, tlen + tq), -torch.inf)
    for i0, j0, rows, own in _tile_chunks(tlen, tq):
        sc, live, *_ = tile_scores(i0, j0, rows, own)
        cur = torch.logsumexp(sc.masked_fill(~live, -torch.inf), dim=-1)
        lse[:, :, i0:i0 + tq] = torch.logaddexp(lse[:, :, i0:i0 + tq], cur)
    lse = lse.nan_to_num(neginf=0.0)
    out = torch.zeros_like(qp)
    for i0, j0, rows, own in _tile_chunks(tlen, tq):
        sc, live, *_ = tile_scores(i0, j0, rows, own)
        p = torch.exp(sc - lse[:, :, i0:i0 + tq, None]) * live
        out[:, :, i0:i0 + tq] += p @ vp[:, :, j0:j0 + TK]
    di = (out[:, :, :tlen + tq] * gp[:, :, :tlen + tq]).sum(-1)   # D_i

    dq = torch.zeros_like(qp)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    dre, du, drb = torch.zeros_like(re), torch.zeros_like(u), torch.zeros_like(rb)
    for i0, j0, rows, own in _tile_chunks(tlen, tq):
        sc, live, qt, qn, e = tile_scores(i0, j0, rows, own)
        p = torch.exp(sc - lse[:, :, i0:i0 + tq, None]) * live
        go = gp[:, :, i0:i0 + tq]
        dp = go @ vp[:, :, j0:j0 + TK].transpose(-1, -2)
        ds = rnd(div(p * (dp - di[:, :, i0:i0 + tq, None])))
        p = rnd(p)
        dv[:, :, j0:j0 + TK] += p.transpose(-1, -2) @ go
        dk[:, :, j0:j0 + TK] += ds.transpose(-1, -2) @ qup[:, :, i0:i0 + tq]
        dq_ac = ds @ kp[:, :, j0:j0 + TK]
        du += dq_ac.sum((0, 2))
        dsk = torch.zeros(b, h, tq, tq + TK)                       # DSk's skew
        dsk[:, :, r_idx, kk_idx - r_idx + tq - 1] = ds
        dsk_own, dsk_nx = dsk * own, dsk * ~own
        dq[:, :, i0:i0 + tq] += dq_ac + dsk_own @ e
        dq[:, :, i0 + 1:i0 + tq + 1] += dsk_nx @ e
        g_re = torch.where(own[:, None], dsk.transpose(-1, -2) @ qt,
                           dsk.transpose(-1, -2) @ qn).sum(0)         # (H, NX, Dh)
        valid = rows >= 0
        dre.index_add_(0, rows[valid], g_re.transpose(0, 1)[valid])
        drb.index_add_(0, rows[valid], dsk.sum((0, 2)).t()[valid])
    back = lambda x: x[:, :, :tlen].transpose(1, 2)
    return tuple(rnd(x) for x in (back(dq), back(dk), back(dv), dre, du, drb))


def _inputs(shape, tlen, seed):
    b, h, dh = shape
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)
    return (mk(b, tlen, h, dh), mk(b, tlen, h, dh), mk(b, tlen, h, dh),
            mk(tlen, h, dh), mk(h, dh), mk(tlen, h), mk(b, tlen, h, dh))


@functools.lru_cache(maxsize=None)
def _references(shape, tlen):
    """Inputs and the gradients of sum(out * dO) by autograd through the
    plain version and by jax.grad through the Pallas kernel (interpret)."""
    *args, g = _inputs(shape, tlen, seed=tlen + shape[2])
    leaves = [t(x).requires_grad_() for x in args]
    (flash_rel_attention_plain(*leaves) * t(g)).sum().backward()
    plain = [x.grad for x in leaves]

    def loss(*a):
        return jnp.sum(jax_flash(*a, True) * g)
    jax_grads = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    return args, g, plain, [np.asarray(x) for x in jax_grads]


NAMES = ("dq", "dk", "dv", "d r_emb", "d r_w_bias", "d r_bias")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%dH%dDh%d" % s)
@pytest.mark.parametrize("tq", [16, 32])
@pytest.mark.parametrize("tlen", T_VALUES)
def test_emulated_tiles_match_plain_and_jax(shape, tq, tlen):
    args, g, plain, jax_grads = _references(shape, tlen)
    got = emulate_flash_bwd(*map(t, args), t(g), tq)
    for name, a, p, j in zip(NAMES, got, plain, jax_grads):
        np.testing.assert_allclose(a.numpy(), p.numpy(), err_msg=f"{name} vs plain", **TOL)
        np.testing.assert_allclose(a.numpy(), j, err_msg=f"{name} vs jax", **TOL)


@functools.lru_cache(maxsize=None)
def _references_bf16(shape, tlen):
    """bf16-valued inputs (unit scale) and output gradient, the plain bf16
    backward's gradients and JAX's bf16 gradients (interpret mode)."""
    b, h, dh = shape
    rng = np.random.RandomState(tlen + dh + 2)
    shapes = [(b, tlen, h, dh)] * 3 + [(tlen, h, dh), (h, dh), (tlen, h)]
    args = [np.asarray(jnp.asarray(rng.randn(*s), jnp.bfloat16).astype(jnp.float32))
            for s in shapes]
    g = rng.randn(b, tlen, h, dh).astype(np.float32)
    leaves = [t(x).to(torch.bfloat16).requires_grad_() for x in args]
    flash_rel_attention_plain(*leaves).backward(t(g))
    _, vjp = jax.vjp(lambda *a: jax_flash(*a, True), *(jnp.asarray(x, jnp.bfloat16)
                                                       for x in args))
    jax_grads = [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g))]
    return args, g, [x.grad.float().numpy() for x in leaves], jax_grads


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%dH%dDh%d" % s)
@pytest.mark.parametrize("tq", [16, 32])
@pytest.mark.parametrize("tlen", T_VALUES)
def test_emulated_bf16_tiles_match_plain_and_jax(shape, tq, tlen):
    args, g, plain, jax_grads = _references_bf16(shape, tlen)
    got = emulate_flash_bwd(*map(t, args), t(g), tq, bf16=True)
    for name, a, p, j in zip(NAMES, got, plain, jax_grads):
        for what, ref in (("plain", p), ("jax", j)):
            slack = np.maximum(2e-3 * np.abs(ref).max(), bf16_step(ref)) + 1e-5
            hold_bf16(f"{name} vs {what}", a.numpy(), ref, slack)


def test_own_next_split_is_by_column():
    """Every column of a chunk's skewed tile is one offset: its cells all
    take q_i (o <= 0) or all q_{i+1} (o >= 1), so the kernel chooses per
    column, never per cell."""
    tq, tlen = 32, 150
    for i0, j0, rows, own in _tile_chunks(tlen, tq):
        r = torch.arange(tq)[:, None]
        kk = torch.arange(TK)[None, :]
        o = (j0 + kk) - (i0 + r)                    # offset of cell (r, kk)
        x = kk - r + tq - 1                         # its column in the skew
        assert torch.equal(o, x + j0 - (i0 + tq - 1))
        assert torch.equal(own[x], o <= 0)


# ---------------------------------------------------------------------------
# 3xTF32 error budget
# ---------------------------------------------------------------------------

CARD_TOL = 1e-4     # atol CARD_TOL * max|ref| + 1e-5, rtol CARD_TOL


def _budget_inputs(seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(32, 64, generator=gen) * 0.5,
            torch.randn(64, 64, generator=gen) * 0.5)


def _within_card_tol(got, ref):
    tol = CARD_TOL * ref.abs().max() + 1e-5 + CARD_TOL * ref.abs()
    return bool(((got.double() - ref).abs() <= tol).all())


def test_tf32_rounding_matches_the_instruction():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12, 3.0e-39])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0,
                         tf32_rna(torch.tensor([3.0e-39]))[0].item()])
    assert torch.equal(tf32_rna(x), want)
    assert not (tf32_rna(torch.randn(1000)).view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("seed", range(5))
def test_3xtf32_product_meets_the_card_tolerance(seed):
    a, b = _budget_inputs(seed)
    ref = a.double() @ b.double()
    got = tc_product(a, b, "3x")
    assert _within_card_tol(got, ref)
    assert (got.double() - ref).abs().max() < 2e-6


@pytest.mark.parametrize("seed", range(5))
def test_single_tf32_product_misses_the_card_tolerance(seed):
    a, b = _budget_inputs(seed)
    ref = a.double() @ b.double()
    got = tc_product(a, b, "1x")
    assert not _within_card_tol(got, ref)
    assert (got.double() - ref).abs().max() > 5e-4
