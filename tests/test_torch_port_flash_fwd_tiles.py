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

The bf16 form's schedule (``bfw::flash_fwd_bf16``) is emulated too, on
its own tiles: query tiles of 64 rows (four warps of 16), key chunks of
64, the table rows in a ring of 256 rows by offset filled 64 at a time
(chunk c reads pieces c and c + 1 while piece c + 2 is copied), each
warp's QE over 80 skewed columns read along its diagonals at kk - r + 16,
the own/next side by column, and every product an m16n8k16 bf16 tile (an
fp32 accumulator that takes each 16-deep step's exact products); AC from
its own tile ``bf16(q + u)``, the scores divided by sqrt(Dh), two sweeps
over the key chunks (the rows' max and sum, then P = exp(s - m) times 1/l
rounded to bf16 for P.V) and the second accumulator of the rest P -
bf16(P), itself rounded to bf16, whose sum with the output is the float32
P's product with v.  Its output is held against the plain bf16 forward
and JAX's bf16 kernel (within 2e-4 of the largest magnitude plus one bf16
step of the row's largest P times max|v|, as in
``tests/test_torch_port_flash_bf16.py``), its lse and sums against the
plain bf16 forward's (``TOL``), at lengths on both sides of its query
tiles and key chunks too.
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

# the bf16 form's tiles: warps per block, keys per chunk, table rows per
# piece of its ring and the ring's rows; a warp's skewed columns (79, padded)
NW_BF, TK_BF, PIECE, RING = 4, 64, 64, 256
TQ_BF = 16 * NW_BF
QX_BF = TK_BF + 16
# its query tiles and key chunks end at multiples of 64
T_VALUES_BF16 = T_VALUES + [191, 192, 193]


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


def _bf16_ring(tlen, i0, re, rb):
    """The table ring as query tile i0's block sees it: yields (c, rows of
    the ring's table rows (RING, H, Dh), its r_bias (RING, H)) at each key
    chunk c; pieces 0 and 1 before chunk 0, piece c + 2 after chunk c."""
    ob = -(i0 + TQ_BF)                       # offset of piece 0's first row
    ring = torch.zeros(RING, *re.shape[1:])
    ring_b = torch.zeros(RING, rb.shape[1])
    nchunks = -(-tlen // TK_BF)

    def fill(p):
        n = PIECE * p + torch.arange(PIECE)
        rows = bd_rows(tlen, ob + n)
        ring[n % RING] = gather_rows(re, rows)
        ring_b[n % RING] = gather_rows(rb, rows)

    fill(0)
    fill(1)
    for c in range(nchunks):
        yield c, ring, ring_b
        if c + 1 < nchunks:
            fill(c + 2)


def emulate_flash_fwd_bf16(q, k, v, re, u, rb):
    """The bf16 form's schedule on float32 tensors holding bf16 values.
    Returns the output (B, T, H, Dh), the row lse (B, H, T) and the float32
    P's product with v (B, T, H, Dh)."""
    b, tlen, h, dh = q.shape
    root = float(np.sqrt(dh))
    rnd = lambda x: x.to(torch.bfloat16).float()
    prod = functools.partial(tc_product, terms="1x", step=16)
    qu = rnd(q + u)
    qh, quh, kh, vh = (x.transpose(1, 2) for x in (q, qu, k, v))   # (B, H, T, Dh)
    pad = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, n))
    qp, qup, kp, vp = pad(qh, TQ_BF + 1), pad(quh, TQ_BF), pad(kh, TK_BF), pad(vh, TK_BF)
    r_idx = torch.arange(16)[:, None]
    kk_idx = torch.arange(TK_BF)[None, :]
    cols = torch.arange(QX_BF)

    def scores(i0, m0, c, ring, ring_b):
        """A warp's 16 rows over chunk c: QE over its skewed columns (ring
        rows PIECE c + x0 + xl), q_i where the offset is <= 0, else q_{i+1}."""
        i, j0 = i0 + m0, c * TK_BF
        slots = (PIECE * c + TQ_BF - 16 - m0 + cols) % RING
        e = ring[slots].transpose(0, 1)                              # (H, 80, Dh)
        eb = ring_b[slots].t()[None, :, None, :]                     # (1, H, 1, 80)
        own = prod(qp[:, :, i:i + 16], e.transpose(-1, -2))
        nxt = prod(qp[:, :, i + 1:i + 17], e.transpose(-1, -2))
        qe = torch.where(cols < i + 17 - j0, own, nxt) + eb
        s_ac = prod(qup[:, :, i:i + 16], kp[:, :, j0:j0 + TK_BF].transpose(-1, -2))
        s = (s_ac + qe[:, :, r_idx, kk_idx - r_idx + 16]) / root
        return torch.where(j0 + kk_idx < tlen, s, torch.full_like(s, NEG))

    def sweep():
        """(i0, m0, c, ring, r_bias ring) for every live warp and chunk."""
        for i0 in range(0, tlen, TQ_BF):
            for c, ring, ring_b in _bf16_ring(tlen, i0, re, rb):
                for m0 in range(0, TQ_BF, 16):
                    if i0 + m0 < tlen:
                        yield i0, m0, c, ring, ring_b

    m = torch.full((b, h, tlen + TQ_BF), NEG)
    l = torch.zeros(b, h, tlen + TQ_BF)
    for i0, m0, c, ring, ring_b in sweep():                          # sweep 1
        i = slice(i0 + m0, i0 + m0 + 16)
        s = scores(i0, m0, c, ring, ring_b)
        m_new = torch.maximum(m[:, :, i], s.amax(-1))
        l[:, :, i] = l[:, :, i] * torch.exp(m[:, :, i] - m_new) + \
            torch.exp(s - m_new[..., None]).sum(-1)
        m[:, :, i] = m_new
    inv_l = 1.0 / l
    o = torch.zeros(b, h, tlen + TQ_BF, dh)
    rest = torch.zeros(b, h, tlen + TQ_BF, dh)
    for i0, m0, c, ring, ring_b in sweep():                          # sweep 2
        i = slice(i0 + m0, i0 + m0 + 16)
        p = torch.exp(scores(i0, m0, c, ring, ring_b) - m[:, :, i, None]) * inv_l[:, :, i, None]
        vc = vp[:, :, c * TK_BF:(c + 1) * TK_BF]
        o[:, :, i] = prod(rnd(p), vc, acc=o[:, :, i])
        rest[:, :, i] = prod(rnd(p - rnd(p)), vc, acc=rest[:, :, i])
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
@pytest.mark.parametrize("tlen", T_VALUES_BF16)
def test_emulated_bf16_tiles_match_plain_and_jax(dh, tlen):
    args, (out_p, lse_p, sums_p), scores, jax_out = _references_bf16(dh, tlen)
    out, lse, sums = emulate_flash_fwd_bf16(*map(t, args))
    flip = flip_allowance(scores, args[2])
    hold_bf16("out vs plain", out.numpy(), out_p.numpy(),
              2e-4 * out_p.abs().max().item() + flip)
    hold_bf16("out vs jax", out.numpy(), jax_out, 2e-4 * np.abs(jax_out).max() + flip)
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), err_msg="lse", **TOL)
    np.testing.assert_allclose(sums.numpy(), sums_p.numpy(), err_msg="sums", **TOL)


@pytest.mark.parametrize("tlen", [1, 64, 65, 300, 513])
def test_bf16_ring_holds_each_chunks_offsets(tlen):
    """The bf16 form's table ring: at chunk c, a warp's skewed column xl
    reads ring row (PIECE c + x0 + xl) mod RING, which holds the table row
    (or zero) of its offset j0 - (i0 + m0) - 16 + xl; the block's reads of
    chunk c (pieces c, c + 1) miss the piece copied meanwhile (c + 2)."""
    re = torch.arange(tlen, dtype=torch.float32)[:, None, None] + 1.0    # row + 1
    rb = torch.zeros(tlen, 1)
    nchunks = -(-tlen // TK_BF)
    for i0 in range(0, tlen, TQ_BF):
        for c, ring, _ in _bf16_ring(tlen, i0, re, rb):
            j0 = c * TK_BF
            read = set()
            for m0 in range(0, TQ_BF, 16):
                x0 = TQ_BF - 16 - m0
                slots = (PIECE * c + x0 + torch.arange(QX_BF)) % RING
                read.update(slots.tolist())
                o = j0 - (i0 + m0) - 16 + torch.arange(QX_BF)
                want = bd_rows(tlen, o).float() + 1.0        # 0 where no row
                assert torch.equal(ring[slots, 0, 0], torch.where(want > 0, want, 0.0))
            if c + 1 < nchunks:
                written = set(((PIECE * (c + 2) + torch.arange(PIECE)) % RING).tolist())
                assert not read & written
