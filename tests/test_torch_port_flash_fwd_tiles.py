"""PyTorch port: the tile algebra of the flash rel-position attention
forward (``csrc/flash_rel_attention_fwd.cu``), proved on the CPU.

The CUDA kernel cannot run here, so this file emulates its schedule in plain
PyTorch: query tiles of TQ = 128 rows, each cut into eight warps of 16 rows;
key chunks of TK = 32; the chunk's table rows over the skewed columns with
the own/next split by column (q_i where the offset o <= 0, q_{i+1} where
o >= 1), each warp's QE over its own 47 columns read along its diagonals;
u . k_j as a per-key term beside q . k_j; an online softmax across chunks
(running max and sum in log2 units, the accumulator rescaled); and every
product in 3xTF32, with hi and lo rounded on the bits and an fp32
accumulator that takes each 8-deep step (``torch_port_helpers.tc_product``).

The emulated output is held against the port's plain version and against
the JAX package's Pallas kernel in interpret mode, on the same numpy inputs,
and its row log-sum-exp against ``torch.logsumexp`` of the plain version's
scores (fp32, ``TOL``: rtol 2e-4, atol 2e-5), at Dh 16, 32 and 64 and at
lengths on both sides of a chunk and of a query tile.

The bf16 form's schedule (``flash_fwd_bf16``) is emulated too: the same
tiles on bf16-valued operands, each product one TF32 pass (exact on bf16
values), AC from its own tile ``bf16(q + u)``, the scores divided by
sqrt(Dh), two sweeps over the key chunks (the rows' max and sum, then P =
exp(s - m) / l rounded to bf16 for P.V) and the second accumulator of the
rest P - bf16(P), rounded to TF32, whose sum with the output is the
float32 P's product with v.  Its output is held against the plain bf16
forward and JAX's bf16 kernel (within 2e-4 of the largest magnitude plus
one bf16 step of the row's largest P times max|v|, as in
``tests/test_torch_port_flash_bf16.py``), its lse and sums against the
plain bf16 forward's (``TOL``).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.ops.pallas.flash_rel_attention import (
    flash_rel_attention as jax_flash)
from transformer_transducer_tpu_torch.models.attention import rel_attention_scores
from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
    flash_rel_attention_plain)

from torch_port_helpers import (
    TOL, bd_rows, flip_allowance, gather_rows, hold_bf16, t, tc_product)

torch.set_num_threads(1)

NW, TK = 8, 32                 # the kernel's warps per block and keys per chunk
TQ = 16 * NW
QX = TK + 16                   # a warp's skewed columns (47), padded
NEG = -1e30
T_VALUES = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 150]
HEAD_DIMS = [16, 32, 64]


def _warp_tiles(tlen):
    """(i0, j0, m0, x0, xs, table rows of the chunk's offsets) for every live
    warp of every query tile and key chunk; local columns xl < xs take q_i."""
    for i0 in range(0, tlen, TQ):
        for j0 in range(0, tlen, TK):
            omin = j0 - (i0 + TQ - 1)
            x = torch.arange(TQ + TK)
            rows = torch.where(x < TQ + TK - 1, bd_rows(tlen, omin + x), -1)
            for m0 in range(0, TQ, 16):
                if i0 + m0 < tlen:
                    x0 = TQ - 16 - m0
                    yield i0, j0, m0, x0, i0 + TQ - j0 - x0, rows


def emulate_flash_fwd(q, k, v, re, u, rb):
    """The kernel's schedule: q, k, v (B, T, H, Dh); re (T, H, Dh), u (H, Dh),
    rb (T, H) sliced to T rows.  Returns the output (B, T, H, Dh) and the row
    log-sum-exp (B, H, T)."""
    b, tlen, h, dh = q.shape
    sl2 = math.log2(math.e) / math.sqrt(dh)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))            # (B, H, T, Dh)
    pad = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, n))
    qp, kp, vp = pad(qh, TQ + 1), pad(kh, TK), pad(vh, TK)
    ub = (u[None, :, None, :] * kp).sum(-1)                         # u . k_j, fp32
    r_idx = torch.arange(16)[:, None]
    kk_idx = torch.arange(TK)[None, :]
    m = torch.full((b, h, tlen + TQ), NEG)
    l = torch.zeros(b, h, tlen + TQ)
    o = torch.zeros(b, h, tlen + TQ, dh)
    for i0, j0, m0, x0, xs, rows in _warp_tiles(tlen):
        i = i0 + m0
        qo, qn = qp[:, :, i:i + 16], qp[:, :, i + 1:i + 17]
        e = gather_rows(re, rows).transpose(0, 1)[:, x0:x0 + QX]     # (H, 48, Dh)
        eb = gather_rows(rb, rows).t()[None, :, None, x0:x0 + QX]    # (1, H, 1, 48)
        s_ac = tc_product(qo, kp[:, :, j0:j0 + TK].transpose(-1, -2), "3x")
        own = tc_product(qo, e.transpose(-1, -2), "3x")
        nxt = tc_product(qn, e.transpose(-1, -2), "3x")
        qe = torch.where(torch.arange(QX) < xs, own, nxt) + eb
        bd = qe[:, :, r_idx, kk_idx - r_idx + 15]                   # diagonal read
        s = (s_ac + ub[:, :, None, j0:j0 + TK] + bd) * sl2
        s = torch.where(j0 + kk_idx < tlen, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m[:, :, i:i + 16], s.amax(-1))
        alpha = torch.exp2(m[:, :, i:i + 16] - m_new)
        p = torch.exp2(s - m_new[..., None])
        m[:, :, i:i + 16] = m_new
        l[:, :, i:i + 16] = l[:, :, i:i + 16] * alpha + p.sum(-1)
        o[:, :, i:i + 16] = tc_product(p, vp[:, :, j0:j0 + TK], "3x",
                                       acc=o[:, :, i:i + 16] * alpha[..., None])
    out = (o / l[..., None])[:, :, :tlen].transpose(1, 2)
    lse = (m + torch.log2(l)) * math.log(2.0)
    return out, lse[:, :, :tlen]


def emulate_flash_fwd_bf16(q, k, v, re, u, rb):
    """The bf16 form's schedule on float32 tensors holding bf16 values.
    Returns the output (B, T, H, Dh), the row lse (B, H, T) and the float32
    P's product with v (B, T, H, Dh)."""
    b, tlen, h, dh = q.shape
    root = float(np.sqrt(dh))
    rnd = lambda x: x.to(torch.bfloat16).float()
    qu = rnd(q + u)
    qh, quh, kh, vh = (x.transpose(1, 2) for x in (q, qu, k, v))   # (B, H, T, Dh)
    pad = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, n))
    qp, qup, kp, vp = pad(qh, TQ + 1), pad(quh, TQ), pad(kh, TK), pad(vh, TK)
    r_idx = torch.arange(16)[:, None]
    kk_idx = torch.arange(TK)[None, :]

    def scores(i0, j0, m0, x0, xs, rows):
        i = i0 + m0
        qo, qn, qa = qp[:, :, i:i + 16], qp[:, :, i + 1:i + 17], qup[:, :, i:i + 16]
        e = gather_rows(re, rows).transpose(0, 1)[:, x0:x0 + QX]     # (H, 48, Dh)
        eb = gather_rows(rb, rows).t()[None, :, None, x0:x0 + QX]    # (1, H, 1, 48)
        s_ac = tc_product(qa, kp[:, :, j0:j0 + TK].transpose(-1, -2), "1x")
        own = tc_product(qo, e.transpose(-1, -2), "1x")
        nxt = tc_product(qn, e.transpose(-1, -2), "1x")
        qe = torch.where(torch.arange(QX) < xs, own, nxt) + eb
        s = (s_ac + qe[:, :, r_idx, kk_idx - r_idx + 15]) / root
        return torch.where(j0 + kk_idx < tlen, s, torch.full_like(s, NEG))

    m = torch.full((b, h, tlen + TQ), NEG)
    l = torch.zeros(b, h, tlen + TQ)
    for i0, j0, m0, x0, xs, rows in _warp_tiles(tlen):               # sweep 1
        i = slice(i0 + m0, i0 + m0 + 16)
        s = scores(i0, j0, m0, x0, xs, rows)
        m_new = torch.maximum(m[:, :, i], s.amax(-1))
        l[:, :, i] = l[:, :, i] * torch.exp(m[:, :, i] - m_new) + \
            torch.exp(s - m_new[..., None]).sum(-1)
        m[:, :, i] = m_new
    o = torch.zeros(b, h, tlen + TQ, dh)
    rest = torch.zeros(b, h, tlen + TQ, dh)
    for i0, j0, m0, x0, xs, rows in _warp_tiles(tlen):               # sweep 2
        i = slice(i0 + m0, i0 + m0 + 16)
        p = torch.exp(scores(i0, j0, m0, x0, xs, rows) - m[:, :, i, None]) / l[:, :, i, None]
        vc = vp[:, :, j0:j0 + TK]
        o[:, :, i] = tc_product(rnd(p), vc, "1x", acc=o[:, :, i])
        rest[:, :, i] = tc_product(p - rnd(p), vc, "1x", acc=rest[:, :, i])
    back = lambda x: x[:, :, :tlen].transpose(1, 2)
    return back(o), (m + torch.log(l))[:, :, :tlen], back(o + rest)


def _inputs(dh, tlen, seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)
    b, h = 2, 2
    return (mk(b, tlen, h, dh), mk(b, tlen, h, dh), mk(b, tlen, h, dh),
            mk(tlen, h, dh), mk(h, dh), mk(tlen, h))


@functools.lru_cache(maxsize=None)
def _references(dh, tlen):
    """Inputs, the plain version's output and row log-sum-exp, and the
    Pallas kernel's output (interpret mode)."""
    args = _inputs(dh, tlen, seed=tlen + dh)
    plain = flash_rel_attention_plain(*map(t, args))
    lse = torch.logsumexp(rel_attention_scores(*(t(args[i]) for i in (0, 1, 3, 4, 5))), -1)
    jax_out = np.asarray(jax_flash(*map(jnp.asarray, args), True))
    return args, plain, lse, jax_out


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("tlen", T_VALUES)
def test_emulated_tiles_match_plain_and_jax(dh, tlen):
    args, plain, lse_ref, jax_out = _references(dh, tlen)
    out, lse = emulate_flash_fwd(*map(t, args))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), err_msg="out vs plain", **TOL)
    np.testing.assert_allclose(out.numpy(), jax_out, err_msg="out vs jax", **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), err_msg="lse", **TOL)


def test_a_warps_columns_hold_its_diagonals():
    """A warp's 16 rows read the skewed columns x0 + kk - r + 15 of the
    chunk, all inside its QX columns; each column is one offset, whose own or
    next side is the column's, never the cell's."""
    tlen = 300
    r = torch.arange(16)[:, None]
    kk = torch.arange(TK)[None, :]
    for i0, j0, m0, x0, xs, _ in _warp_tiles(tlen):
        xl = kk - r + 15
        assert int(xl.min()) >= 0 and int(xl.max()) < QX
        o = (j0 + kk) - (i0 + m0 + r)                  # offset of cell (r, kk)
        assert torch.equal(o, x0 + xl + j0 - (i0 + TQ - 1))
        assert torch.equal(xl < xs, o <= 0)


@functools.lru_cache(maxsize=None)
def _references_bf16(dh, tlen):
    """bf16-valued inputs (unit scale), the plain bf16 forward's output, lse
    and sums, its scores, and JAX's bf16 output (interpret mode)."""
    rng = np.random.RandomState(tlen + dh + 1)
    b, h = 2, 2
    shapes = [(b, tlen, h, dh)] * 3 + [(tlen, h, dh), (h, dh), (tlen, h)]
    args = [np.asarray(jnp.asarray(rng.randn(*s), jnp.bfloat16).astype(jnp.float32))
            for s in shapes]
    bf = [t(x).to(torch.bfloat16) for x in args]
    plain = fa.flash_bf16_forward_plain(*bf)
    scores = fa._bf16_parts(*bf[:2], *bf[3:])[-1]
    jax_out = np.asarray(jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in args), True),
                         np.float32)
    return args, plain, scores, jax_out


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("tlen", T_VALUES)
def test_emulated_bf16_tiles_match_plain_and_jax(dh, tlen):
    args, (out_p, lse_p, sums_p), scores, jax_out = _references_bf16(dh, tlen)
    out, lse, sums = emulate_flash_fwd_bf16(*map(t, args))
    flip = flip_allowance(scores, args[2])
    hold_bf16("out vs plain", out.numpy(), out_p.numpy(),
              2e-4 * out_p.abs().max().item() + flip)
    hold_bf16("out vs jax", out.numpy(), jax_out, 2e-4 * np.abs(jax_out).max() + flip)
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), err_msg="lse", **TOL)
    np.testing.assert_allclose(sums.numpy(), sums_p.numpy(), err_msg="sums", **TOL)
