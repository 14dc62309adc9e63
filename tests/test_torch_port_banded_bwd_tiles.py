"""PyTorch port: the schedule of the banded rel-position attention backward
(``csrc/banded_attention_bwd.cu``), proved on the CPU.

The CUDA kernels cannot run here, so this file emulates their schedule in
plain PyTorch.  A block owns TQ rows and the TQ keys of the same indices of
one (b, h).  It walks the band's offsets o in chunks of OC and, for each
chunk, the rows whose band reaches its keys (plus row i0 - 1, whose wrap
term feeds dq of row i0) in tiles of RC rows, and computes p and dS only for
the cells (i, o) some gradient of the block needs.  From those cells it
writes dq of its rows (the AC part, the own BD part and the wrap share of
row i - 1), dk and dv of its keys, and per-block partials of the table
gradients for its own rows and the live offsets only, and zeroes the table
rows of its indices that no offset reads; a second pass, one block per
offset, sums the partials over the blocks in a fixed order into the table
row the offset reads (and d r_w_bias).  Every output entry is written
once, so the wrapper allocates them uninitialised: the emulation starts
them at NaN to show it.

The emulated gradients are held against autograd through the port's plain
version and against ``jax.grad`` through the JAX package's Pallas kernel in
interpret mode, on the same numpy inputs (fp32, ``TOL``: rtol 2e-4, atol
2e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.ops.pallas.banded_attention import (
    banded_attention as jax_banded)
from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
    banded_attention_plain)

from torch_port_helpers import TOL, bd_rows, gather_rows, t

torch.set_num_threads(1)

TQ, RC, OC = 32, 48, 16          # the kernel's tile: rows/keys, row chunk, offsets
T_VALUES = [1, 2, TQ - 1, TQ, TQ + 1, 2 * TQ + 1, 150]
BANDS = [(10, 2), (0, 0), (3, 64), (64, 0), (64, 64)]
SHAPES = [(2, 2, 16), (1, 1, 64)]        # (B, H, Dh)


def row_range(i0, tlen, oa, ob):
    """Rows a block at i0 visits for the offset chunk [oa, ob): its own rows,
    the rows whose band over the chunk reaches its keys and, when the chunk
    holds an o >= 1, row i0 - 1 (the wrap term of dq_{i0})."""
    return max(0, i0 - max(0, ob - 1)), min(tlen, i0 + TQ + max(0, -oa))


def row_reached(row, tlen, left, right):
    """Whether an offset of the band reads table row ``row``: o = row -
    (T - 1) (o <= 0) or o = row + 2 (o >= 2)."""
    return row - (tlen - 1) >= -left or row + 2 <= right


def _take(x, idx, tlen):
    """x[:, :, idx] for x (B, H, T, ...) with zeros where idx is outside
    [0, T)."""
    ok = (idx >= 0) & (idx < tlen)
    out = x[:, :, idx.clamp(0, tlen - 1)]
    return out * ok.view(*ok.shape, *([1] * (out.dim() - 2 - ok.dim()))).to(out.dtype)


def emulate_banded_bwd(q, k, v, re, u, rb, dout, left, right):
    """The kernels' schedule: q, k, v, dout (B, T, H, Dh); re (T, H, Dh),
    u (H, Dh), rb (T, H) sliced to T rows.  Returns (dq, dk, dv, d re, d u,
    d rb).  The forward's output and row log-sum-exp come from the same cell
    rule."""
    b, tlen, h, dh = q.shape
    scale = 1.0 / dh ** 0.5
    nw = left + right + 1
    qh, kh, vh, gh = (x.transpose(1, 2) for x in (q, k, v, dout))   # (B, H, T, Dh)

    def cells(rows, offs):
        """Scaled scores and liveness of cells (rows[:, None], offs[None])."""
        keys = rows[:, None] + offs[None]
        q_i, q_n = _take(qh, rows, tlen), _take(qh, rows + 1, tlen)
        k_j = _take(kh, keys, tlen)
        tab = bd_rows(tlen, offs)
        e = gather_rows(re, tab).transpose(0, 1)                    # (H, X, Dh)
        eb = gather_rows(rb, tab).t()                               # (H, X)
        ac = ((q_i + u[None, :, None])[:, :, :, None] * k_j).sum(-1)
        q_sel = torch.where((offs <= 0)[None, None, None, :, None],
                            q_i[:, :, :, None], q_n[:, :, :, None])
        bd = (q_sel * e[None, :, None]).sum(-1) + eb[None, :, None]
        live = ((rows[:, None] >= 0) & (rows[:, None] < tlen) & (keys >= 0)
                & (keys < tlen) & (offs[None] >= -left) & (offs[None] <= right))
        return (ac + bd) * scale, live, keys, e, q_i, q_n

    # the forward's row statistics over the whole band
    rows_all, offs_all = torch.arange(tlen), torch.arange(-left, right + 1)
    sc, live, keys, *_ = cells(rows_all, offs_all)
    sc = sc.masked_fill(~live, -torch.inf)
    lse = torch.logsumexp(sc, dim=-1)                               # (B, H, T)
    p_all = torch.exp(sc - lse[..., None])
    out = (p_all[..., None] * _take(vh, keys, tlen)).sum(-2)
    di = (out * gh).sum(-1)                                         # D_i

    nan = lambda *s: torch.full(s, torch.nan)
    ntile = -(-tlen // TQ)
    dq, dk, dv = nan(b, h, tlen, dh), nan(b, h, tlen, dh), nan(b, h, tlen, dh)
    part = nan(b, ntile, h, nw + 1, dh + 1)     # per-block table partials, row nw: d u
    dre, drb = nan(tlen, h, dh), nan(tlen, h)
    for tile, i0 in enumerate(range(0, tlen, TQ)):
        own = lambda idx: (idx >= i0) & (idx < min(i0 + TQ, tlen))
        dq_ac, dq_bd = torch.zeros(b, h, TQ, dh), torch.zeros(b, h, TQ, dh)
        dk_acc, dv_acc, gsum = (torch.zeros(b, h, TQ, dh), torch.zeros(b, h, TQ, dh),
                                torch.zeros(b, h, TQ))
        for oa in range(-left, right + 1, OC):
            ob = min(oa + OC, right + 1)
            offs = torch.arange(oa, oa + OC)
            lo, hi = row_range(i0, tlen, oa, ob)
            g_tab, g_tabb = torch.zeros(b, h, OC, dh), torch.zeros(b, h, OC)
            for r0 in range(lo, hi, RC):
                rows = torch.arange(r0, r0 + RC)
                sc, live, keys, e, q_i, q_n = cells(rows, offs)
                need = live & (own(rows)[:, None] | own(keys)
                               | ((rows[:, None] == i0 - 1) & (offs[None] >= 2)))
                lse_r = _take(lse[..., None], rows, tlen)[..., 0]
                di_r = _take(di[..., None], rows, tlen)[..., 0]
                p = torch.exp(sc - lse_r[..., None]) * need
                dp = (_take(gh, rows, tlen)[:, :, :, None] * _take(vh, keys, tlen)).sum(-1)
                ds = p * (dp - di_r[..., None]) * scale
                # (a) dq of the own rows in the tile, and the wrap share from
                # the row before each own row when that row is in the tile
                k_j = _take(kh, keys, tlen)
                own_o = (offs <= 0).float()[None, None, None, :, None]
                nxt_o = (offs >= 2).float()[None, None, None, :, None]
                bd_own = (ds[..., None] * own_o * e[None, :, None]).sum(-2)
                bd_nxt = (ds[..., None] * nxt_o * e[None, :, None]).sum(-2)
                ac = (ds[..., None] * k_j).sum(-2)
                mine, below = own(rows), own(rows + 1)
                dq_ac.index_add_(2, (rows - i0)[mine], ac[:, :, mine])
                dq_bd.index_add_(2, (rows - i0)[mine], bd_own[:, :, mine])
                dq_bd.index_add_(2, (rows + 1 - i0)[below], bd_nxt[:, :, below])
                # (b) dk, dv of the own keys: every cell whose key is own
                sel = own(keys)
                kj_local = (keys - i0)[sel]
                p_sel, ds_sel = p[:, :, sel], ds[:, :, sel]             # (B, H, n)
                ridx = rows[:, None].expand_as(keys)[sel]
                dv_acc.index_add_(2, kj_local, p_sel[..., None] * _take(gh, ridx, tlen))
                dk_acc.index_add_(2, kj_local, ds_sel[..., None] * _take(qh, ridx, tlen))
                gsum.index_add_(2, kj_local, ds_sel)
                # (c) table partials over the own rows
                mine = mine.float()[None, None, :, None]
                q_sel = torch.where((offs <= 0)[None, None, None, :, None],
                                    q_i[:, :, :, None], q_n[:, :, :, None])
                g_tab += ((ds * mine)[..., None] * q_sel).sum(2)
                g_tabb += (ds * mine).sum(2)
            nx = ob - oa
            part[:, tile, :, oa + left:ob + left, :dh] = g_tab[:, :, :nx]
            part[:, tile, :, oa + left:ob + left, dh] = g_tabb[:, :, :nx]
        n_own = min(TQ, tlen - i0)
        dq[:, :, i0:i0 + n_own] = (dq_ac + dq_bd)[:, :, :n_own]
        dk_own = dk_acc + gsum[..., None] * u[None, :, None]
        dk[:, :, i0:i0 + n_own] = dk_own[:, :, :n_own]
        dv[:, :, i0:i0 + n_own] = dv_acc[:, :, :n_own]
        part[:, tile, :, nw, :dh] = dq_ac.sum(2)
        part[:, tile, :, nw, dh] = 0.0
        # the block's table rows that no offset reads get zeros here
        for row in range(i0, i0 + n_own):
            if not row_reached(row, tlen, left, right):
                dre[row], drb[row] = 0.0, 0.0
    # the second pass, one block per offset: the partials summed over the
    # blocks in order into the table row the offset reads, with those of the
    # other offset that reads the same row (the block of o <= 0 takes both)
    part = part.reshape(b * ntile, h, nw + 1, dh + 1)
    for o in range(-left, right + 1):
        row = int(bd_rows(tlen, torch.tensor(o)))
        if row < 0 or (o >= 2 and row - (tlen - 1) >= -left):
            continue
        pair = [o] + ([row + 2] if o <= 0 and row + 2 <= right else [])
        acc = torch.zeros(h, dh + 1)
        for blk in range(b * ntile):
            for x in pair:
                acc += part[blk, :, x + left]
        dre[row], drb[row] = acc[:, :dh], acc[:, dh]
    du = torch.zeros(h, dh)
    for blk in range(b * ntile):
        du += part[blk, :, nw, :dh]
    back = lambda x: x.transpose(1, 2)
    return back(dq), back(dk), back(dv), dre, du, drb


def _inputs(shape, tlen, seed):
    b, h, dh = shape
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)
    return (mk(b, tlen, h, dh), mk(b, tlen, h, dh), mk(b, tlen, h, dh),
            mk(tlen, h, dh), mk(h, dh), mk(tlen, h), mk(b, tlen, h, dh))


@functools.lru_cache(maxsize=None)
def _references(shape, tlen, band):
    """Inputs and the gradients of sum(out * dO) by autograd through the
    plain version and by jax.grad through the Pallas kernel (interpret)."""
    *args, g = _inputs(shape, tlen, seed=tlen + shape[2] + 7 * band[0] + band[1])
    leaves = [t(x).requires_grad_() for x in args]
    (banded_attention_plain(*leaves, *band) * t(g)).sum().backward()
    plain = [x.grad for x in leaves]

    def loss(*a):
        return jnp.sum(jax_banded(*a, *band, interpret=True) * g)
    jax_grads = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    return args, g, plain, [np.asarray(x) for x in jax_grads]


NAMES = ("dq", "dk", "dv", "d r_emb", "d r_w_bias", "d r_bias")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%dH%dDh%d" % s)
@pytest.mark.parametrize("band", BANDS, ids=lambda b: "band%d_%d" % b)
@pytest.mark.parametrize("tlen", T_VALUES)
def test_emulated_schedule_matches_plain_and_jax(shape, band, tlen):
    args, g, plain, jax_grads = _references(shape, tlen, band)
    got = emulate_banded_bwd(*map(t, args), t(g), *band)
    for name, a, p, j in zip(NAMES, got, plain, jax_grads):
        assert not a.isnan().any(), f"{name}: an entry was never written"
        np.testing.assert_allclose(a.numpy(), p.numpy(), err_msg=f"{name} vs plain", **TOL)
        np.testing.assert_allclose(a.numpy(), j, err_msg=f"{name} vs jax", **TOL)


@pytest.mark.parametrize("band", BANDS, ids=lambda b: "band%d_%d" % b)
def test_each_band_cell_feeds_each_gradient_once(band):
    """Over all blocks, every live cell (i, o) is visited by exactly one
    block for dq_i, one for the wrap share of dq_{i+1} (o >= 2), one for
    dk_j and dv_j, and one for the table partial of o."""
    left, right = band
    tlen = 150
    counts = {name: torch.zeros(tlen, left + right + 1, dtype=torch.int64)
              for name in ("dq", "wrap", "dkv", "table")}
    for i0 in range(0, tlen, TQ):
        own = lambda idx: (idx >= i0) & (idx < min(i0 + TQ, tlen))
        for oa in range(-left, right + 1, OC):
            ob = min(oa + OC, right + 1)
            lo, hi = row_range(i0, tlen, oa, ob)
            for i in range(lo, hi):
                for o in range(oa, ob):
                    j = i + o
                    if not 0 <= j < tlen:
                        continue
                    x = o + left
                    counts["dq"][i, x] += int(own(i))
                    counts["table"][i, x] += int(own(i))
                    counts["wrap"][i, x] += int(o >= 2 and own(i + 1))
                    counts["dkv"][i, x] += int(own(j))
    i = torch.arange(tlen)[:, None]
    o = torch.arange(-left, right + 1)[None]
    live = (i + o >= 0) & (i + o < tlen)
    for name in ("dq", "table", "dkv"):
        assert torch.equal(counts[name], live.long()), name
    wrap = live & (o >= 2) & (i + 1 < tlen)
    assert torch.equal(counts["wrap"], wrap.long())
