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

The bf16 form (``bbw::flash_bwd_bf16`` and its pre-pass) has a schedule of
its own, emulated by ``emulate_flash_bwd_bf16``: key-major blocks of TK =
64 keys that walk query steps of TQ = 32 rows; the scores transposed (keys
as rows: S^T = K . qu^T + BD^T, dP^T = V . dO^T); BD^T read along the
diagonals of QE over the step's 96 skewed columns, whose table rows come
from a ring of four 32-row pieces by offset (piece st + 1 copied while
step st reads pieces st - 2 .. st); dV and dK summed over every step and
written once; dq a pass a step (dS . K and DSk's own columns to row r, its
next columns to row r + 1); d re and d rb summed in a ring of three
pieces that leave once a block as the window slides (``_emitted_after``);
d u from the keys' column sums of dS; every product an m16n8k16 bf16 tile
(an fp32 accumulator that takes each 16-deep step's exact products); the
pre-pass's bf16 dO and q + u, and D_i from the forward's float32 P . v
sums.  It is held against the plain bf16 backward and ``jax.grad`` through
the Pallas kernels on bf16 inputs, each gradient within 2e-3 of its
leaf's largest magnitude or one bf16 step of the element (the final
cast), plus 1e-5, at Dh 16, 32 and 64 and at lengths on both sides of the
key and query tiles; ``test_bf16_rings_hold_each_steps_offsets`` checks
the rings' indices: every column reads its offset's table row, and each
live offset leaves once a block.

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
from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
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


def emulate_flash_bwd(q, k, v, re, u, rb, dout, tq):
    """The kernel's schedule: q, k, v, dout (B, T, H, Dh); re (T, H, Dh), u
    (H, Dh), rb (T, H) sliced to T rows.  Returns (dq, dk, dv, d re, d u,
    d rb).  The forward's output and row log-sum-exp come from the same
    tiles."""
    b, tlen, h, dh = q.shape
    scale = 1.0 / dh ** 0.5
    qu_all = q + u
    div = lambda x: x * scale
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
        ds = div(p * (dp - di[:, :, i0:i0 + tq, None]))
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
    return back(dq), back(dk), back(dv), dre, du, drb


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


# the bf16 form's tiles: keys a block, query rows a step, offsets a piece
# of the rings, a step's skewed columns (three pieces), the slots of the
# table ring (one piece more, copied meanwhile) and of the gradient ring
TK_BF, TQ_BF, PIECE = 64, 32, 32
NX_BF = TQ_BF + TK_BF
E_SLOTS, G_SLOTS = NX_BF // PIECE + 1, NX_BF // PIECE
# key tiles and query steps end at multiples of 64 and 32
T_VALUES_BF16 = [1, 17, 31, 32, 33, 63, 64, 65, 96, 97, 129]
HEAD_DIMS_BF16 = [16, 32, 64]


def _origin(j0, m):
    """The offset of piece m's first row in the block of keys from j0."""
    return j0 - (TQ_BF - 1) - PIECE * m


def _column_piece(st, x):
    """The piece that holds column x (offset j0 - i0 - TQ + 1 + x) at step st."""
    return st - x // PIECE


def _emitted_after(st, nsteps):
    """The pieces whose offsets no later step touches: the window's top
    piece after each step, all three after the last."""
    return [st - 2] + ([st - 1, st] if st == nsteps - 1 else [])


def _ring_rows(st, slots):
    """Ring row of each of the step's NX columns (a ring of ``slots`` pieces)."""
    x = torch.arange(NX_BF)
    return torch.remainder(_column_piece(st, x), slots) * PIECE + x % PIECE


def emulate_flash_bwd_bf16(q, k, v, re, u, rb, dout, lse, sums):
    """The bf16 form's schedule on float32 tensors holding bf16 values: q,
    k, v, dout (B, T, H, Dh); re (T, H, Dh), u (H, Dh), rb (T, H); lse (B, H,
    T) and sums (B, T, H, Dh) as the bf16 forward keeps them.  Returns (dq,
    dk, dv, d re, d u, d rb), each rounded to bf16."""
    b, tlen, h, dh = q.shape
    root = float(np.sqrt(dh))
    rnd = lambda x: x.to(torch.bfloat16).float()
    prod = functools.partial(tc_product, terms="1x", step=16)
    # the pre-pass
    qu, go = rnd(q + u), rnd(dout)
    dd = (go * sums).sum(-1).transpose(1, 2)                          # (B, H, T)
    nsteps = -(-tlen // TQ_BF)
    ntiles = -(-tlen // TK_BF)
    tq_pad, tk_pad = nsteps * TQ_BF, ntiles * TK_BF
    pad = lambda x, n: torch.nn.functional.pad(x.transpose(1, 2), (0, 0, 0, n - tlen))
    qh, quh, goh = pad(q, tq_pad + 1), pad(qu, tq_pad), pad(go, tq_pad)   # (B, H, T', Dh)
    kh, vh = pad(k, tk_pad), pad(v, tk_pad)
    lse_p, dd_p = (torch.nn.functional.pad(x, (0, tq_pad - tlen)) for x in (lse, dd))
    dq = torch.zeros(b, h, tq_pad + 1, dh)
    dk, dv = torch.zeros(b, h, tk_pad, dh), torch.zeros(b, h, tk_pad, dh)
    dre, du, drb = torch.zeros_like(re), torch.zeros(h, dh), torch.zeros_like(rb)
    kk_i = torch.arange(TK_BF)[:, None]                  # the scores' rows: keys
    r_i = torch.arange(TQ_BF)[None, :]                   # their columns: queries
    skew = kk_i - r_i + TQ_BF - 1                        # column of cell (kk, r)
    cols = torch.arange(NX_BF)
    for j0 in range(0, tlen, TK_BF):
        kt, vt = kh[:, :, j0:j0 + TK_BF], vh[:, :, j0:j0 + TK_BF]
        e_ring = torch.zeros(h, E_SLOTS * PIECE, dh)
        eb_ring = torch.zeros(h, E_SLOTS * PIECE)
        g_ring = torch.zeros(b, h, G_SLOTS * PIECE, dh)
        gb_ring = torch.zeros(b, h, G_SLOTS * PIECE)

        def rows_of(m):
            return bd_rows(tlen, _origin(j0, m) + torch.arange(PIECE))

        def fill(m):
            at = slice(m % E_SLOTS * PIECE, (m % E_SLOTS + 1) * PIECE)
            e_ring[:, at] = gather_rows(re, rows_of(m)).transpose(0, 1)
            eb_ring[:, at] = gather_rows(rb, rows_of(m)).t()

        def emit(m):
            at = slice(m % G_SLOTS * PIECE, (m % G_SLOTS + 1) * PIECE)
            rows = rows_of(m)
            ok = rows >= 0
            dre.index_add_(0, rows[ok], g_ring[:, :, at].sum(0).transpose(0, 1)[ok])
            drb.index_add_(0, rows[ok], gb_ring[:, :, at].sum(0).t()[ok])
            g_ring[:, :, at] = 0.0
            gb_ring[:, :, at] = 0.0

        for m in range(1 - NX_BF // PIECE, 1):
            fill(m)
        dk_acc, dv_acc = torch.zeros(b, h, TK_BF, dh), torch.zeros(b, h, TK_BF, dh)
        cs = torch.zeros(b, h, TK_BF)
        for st in range(nsteps):
            i0 = st * TQ_BF
            own = cols < i0 + TQ_BF - j0                 # offset <= 0: q_i, else q_{i+1}
            e = e_ring[:, _ring_rows(st, E_SLOTS)]        # (H, NX, Dh)
            eb = eb_ring[:, _ring_rows(st, E_SLOTS)]
            qt, qn = qh[:, :, i0:i0 + TQ_BF], qh[:, :, i0 + 1:i0 + TQ_BF + 1]
            qut, got = quh[:, :, i0:i0 + TQ_BF], goh[:, :, i0:i0 + TQ_BF]
            # A: QE + rb over the skewed columns, own/next by column
            qe = torch.where(own, prod(qt, e.transpose(-1, -2)),
                             prod(qn, e.transpose(-1, -2))) + eb[None, :, None, :]
            # B: the transposed scores, P, dS; dV and dK
            s_t = prod(kt, qut.transpose(-1, -2)) + qe[:, :, r_i, skew]
            dp_t = prod(vt, got.transpose(-1, -2))
            live = ((j0 + kk_i) < tlen) & ((i0 + r_i) < tlen)
            p = torch.where(live, torch.exp(s_t / root - lse_p[:, :, None, i0:i0 + TQ_BF]), 0.0)
            ds = rnd(p * (dp_t - dd_p[:, :, None, i0:i0 + TQ_BF]) / root)
            cs += ds.sum(-1)
            dv_acc = prod(rnd(p), got, acc=dv_acc)
            dk_acc = prod(ds, qut, acc=dk_acc)
            dsk = torch.zeros(b, h, TQ_BF, NX_BF)
            dsk[:, :, r_i.expand_as(skew), skew] = ds
            # C: dq (rows r; the next columns to row r + 1), the gradient ring
            acc = prod(dsk * own, e, acc=prod(ds.transpose(-1, -2), kt))
            dq[:, :, i0:i0 + TQ_BF] += acc
            dq[:, :, i0 + 1:i0 + TQ_BF + 1] += prod(dsk * ~own, e)
            dsk_t = dsk.transpose(-1, -2)
            g_rows = _ring_rows(st, G_SLOTS)
            g_ring[:, :, g_rows] += torch.where(own[:, None], prod(dsk_t, qt), prod(dsk_t, qn))
            gb_ring[:, :, g_rows] += prod(dsk_t, torch.ones(TQ_BF, 1))[..., 0]
            # D: the pieces that leave the window; piece st + 1 was copied
            # into a slot no column of step st reads
            for m in _emitted_after(st, nsteps):
                emit(m)
            if st + 1 < nsteps:
                fill(st + 1)
        dk[:, :, j0:j0 + TK_BF], dv[:, :, j0:j0 + TK_BF] = dk_acc, dv_acc
        du += (cs[..., None] * kt).sum((0, 2))
    back = lambda x: x[:, :, :tlen].transpose(1, 2)
    return tuple(rnd(x) for x in (back(dq), back(dk), back(dv), dre, du, drb))


@functools.lru_cache(maxsize=None)
def _references_bf16(dh, tlen):
    """bf16-valued inputs (unit scale) and output gradient, the plain bf16
    forward's lse and sums, the plain bf16 backward's gradients and JAX's
    bf16 gradients (interpret mode)."""
    b, h = 2, 2
    rng = np.random.RandomState(tlen + dh + 2)
    shapes = [(b, tlen, h, dh)] * 3 + [(tlen, h, dh), (h, dh), (tlen, h)]
    args = [np.asarray(jnp.asarray(rng.randn(*s), jnp.bfloat16).astype(jnp.float32))
            for s in shapes]
    g = rng.randn(b, tlen, h, dh).astype(np.float32)
    leaves = [t(x).to(torch.bfloat16).requires_grad_() for x in args]
    _, lse, sums = fa.flash_bf16_forward_plain(*(x.detach() for x in leaves))
    flash_rel_attention_plain(*leaves).backward(t(g))
    _, vjp = jax.vjp(lambda *a: jax_flash(*a, True), *(jnp.asarray(x, jnp.bfloat16)
                                                       for x in args))
    jax_grads = [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g))]
    return args, g, lse, sums, [x.grad.float().numpy() for x in leaves], jax_grads


@pytest.mark.parametrize("dh", HEAD_DIMS_BF16)
@pytest.mark.parametrize("tlen", T_VALUES_BF16)
def test_emulated_bf16_tiles_match_plain_and_jax(dh, tlen):
    args, g, lse, sums, plain, jax_grads = _references_bf16(dh, tlen)
    got = emulate_flash_bwd_bf16(*map(t, args), t(g), lse, sums)
    for name, a, p, j in zip(NAMES, got, plain, jax_grads):
        for what, ref in (("plain", p), ("jax", j)):
            slack = np.maximum(2e-3 * np.abs(ref).max(), bf16_step(ref)) + 1e-5
            hold_bf16(f"{name} vs {what}", a.numpy(), ref, slack)


@pytest.mark.parametrize("tlen", [1, 31, 33, 64, 97, 300, 410, 513])
def test_bf16_rings_hold_each_steps_offsets(tlen):
    """The bf16 form's rings, block by block: at step st column x reads the
    table ring's row of its offset j0 - i0 - TQ + 1 + x (the piece copied
    during the step is in a slot no column reads); its gradient goes to
    the gradient ring's row that holds that offset since the offset
    entered the window, and each offset of the block leaves once, after its
    last step; every offset some live cell of the block has leaves."""
    nsteps = -(-tlen // TQ_BF)
    for j0 in range(0, tlen, TK_BF):
        e_ring = [None] * (E_SLOTS * PIECE)
        g_ring = [None] * (G_SLOTS * PIECE)         # offset a row holds since its zeroing
        left = []

        def fill(m):
            for p in range(PIECE):
                e_ring[m % E_SLOTS * PIECE + p] = _origin(j0, m) + p

        for m in range(1 - NX_BF // PIECE, 1):
            fill(m)
        for st in range(nsteps):
            i0 = st * TQ_BF
            o = j0 - i0 - TQ_BF + 1 + torch.arange(NX_BF)
            assert [e_ring[x] for x in _ring_rows(st, E_SLOTS).tolist()] == o.tolist()
            if st + 1 < nsteps:
                copied = set(range((st + 1) % E_SLOTS * PIECE, ((st + 1) % E_SLOTS + 1) * PIECE))
                assert not copied & set(_ring_rows(st, E_SLOTS).tolist())
            for x, row in enumerate(_ring_rows(st, G_SLOTS).tolist()):
                assert int(o[x]) not in left            # no step after it leaves
                if g_ring[row] is None:
                    g_ring[row] = int(o[x])
                assert g_ring[row] == int(o[x])
            for m in _emitted_after(st, nsteps):
                at = m % G_SLOTS * PIECE
                for p in range(PIECE):
                    off = _origin(j0, m) + p
                    assert g_ring[at + p] in (None, off)
                    left.append(off)
                    g_ring[at + p] = None
            if st + 1 < nsteps:
                fill(st + 1)
        assert len(left) == len(set(left))
        live = {j - i for j in range(j0, min(j0 + TK_BF, tlen)) for i in range(tlen)}
        assert live <= set(left)


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
