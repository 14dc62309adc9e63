"""PyTorch port: the schedule of the banded rel-position attention forward
(``csrc/rel_attention.cu``, ``banded_fwd``), proved on the CPU.

The CUDA kernel cannot run here, so this file emulates its schedule in plain
PyTorch.  A block owns TQ query rows of one (b, h) and stages them once,
with one more row for the wrap term q_{i+1} (zero past T).  It walks the
band's offsets o in chunks [oa, oa + OC), skipping a chunk whose keys lie
off the sequence for every row of the block; a chunk stages the TQ + OC - 1
keys and values its cells reach (zero off the sequence), u . k_j for each,
and the table rows and r_bias of its OC offsets only (zero past the band's
right edge, at o == 1 and off the table).  Cell (row r, offset oa + x)
reads key row r + x of the staged window; only cells inside the band and
the sequence count.  An online softmax (running max, sum, rescaled
accumulator) carries across chunks; each row is stored once, with its
log-sum-exp.  The outputs start at NaN to show that every entry of a row
inside the sequence is written.

The emulated output is held against the port's plain version and against
the JAX package's Pallas kernel in interpret mode, on the same numpy inputs,
and its log-sum-exp against the band-masked ``torch.logsumexp`` of the
plain version's scores (``rel_attention_scores``), in fp32 at ``TOL``
(rtol 2e-4, atol 2e-5).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.ops.pallas.banded_attention import (
    banded_attention as jax_banded)
from transformer_transducer_tpu_torch.models.attention import rel_attention_scores
from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
    banded_attention_plain)
from transformer_transducer_tpu_torch.ops.masks import context_mask

from torch_port_helpers import TOL, bd_rows, gather_rows, t

torch.set_num_threads(1)

TQ, OC = 32, 16                  # the kernel's rows a block and offsets a chunk
NK = TQ + OC - 1                 # keys a chunk's cells reach
NEG = -1e30
T_VALUES = [1, 2, TQ - 1, TQ, TQ + 1, 2 * TQ + 1, 150]
BANDS = [(10, 2), (0, 0), (3, 64), (64, 0), (64, 64)]
SHAPES = [(2, 2, 16), (1, 1, 64)]        # (B, H, Dh)


def chunks(i0, tlen, left, right):
    """The offset chunks (oa, nx) a block at i0 works on: those whose keys
    reach the sequence for some row of the block."""
    iend = min(i0 + TQ, tlen)
    for oa in range(-left, right + 1, OC):
        nx = min(OC, right + 1 - oa)
        if iend - 1 + oa + nx - 1 >= 0 and i0 + oa < tlen:
            yield oa, nx


def _take(x, idx, tlen):
    """x[:, :, idx] for x (B, H, T, ...) with zeros where idx is outside
    [0, T)."""
    ok = (idx >= 0) & (idx < tlen)
    out = x[:, :, idx.clamp(0, tlen - 1)]
    return out * ok.view(*ok.shape, *([1] * (out.dim() - 2 - ok.dim()))).to(out.dtype)


def emulate_banded_fwd(q, k, v, re, u, rb, left, right):
    """The kernel's schedule: q, k, v (B, T, H, Dh); re (T, H, Dh), u (H, Dh),
    rb (T, H) sliced to T rows.  Returns the output (B, T, H, Dh) and the row
    log-sum-exp (B, H, T)."""
    b, tlen, h, dh = q.shape
    scale = 1.0 / dh ** 0.5
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))            # (B, H, T, Dh)
    out = torch.full((b, h, tlen, dh), torch.nan)
    lse = torch.full((b, h, tlen), torch.nan)
    r = torch.arange(TQ)[:, None]
    x = torch.arange(OC)[None]
    for i0 in range(0, tlen, TQ):
        n_own = min(TQ, tlen - i0)
        q_tile = _take(qh, torch.arange(i0, i0 + TQ + 1), tlen)    # (B, H, TQ + 1, Dh)
        q_i, q_n = q_tile[:, :, :TQ], q_tile[:, :, 1:]
        m = torch.full((b, h, TQ), NEG)
        l = torch.zeros(b, h, TQ)
        acc = torch.zeros(b, h, TQ, dh)
        for oa, nx in chunks(i0, tlen, left, right):
            keys = torch.arange(i0 + oa, i0 + oa + NK)
            k_tile, v_tile = _take(kh, keys, tlen), _take(vh, keys, tlen)
            offs = torch.arange(oa, oa + OC)
            tab = torch.where(offs <= right, bd_rows(tlen, offs), -1)
            e = gather_rows(re, tab).transpose(0, 1)                # (H, OC, Dh)
            eb = gather_rows(rb, tab).t()                           # (H, OC)
            uk = (u[None, :, None] * k_tile).sum(-1)                # (B, H, NK)
            kk = r + x                                              # staged key row
            q_sel = torch.where((offs <= 0)[None, None, None, :, None],
                                q_i[:, :, :, None], q_n[:, :, :, None])
            sc = ((q_i[:, :, :, None] * k_tile[:, :, kk]).sum(-1)
                  + (q_sel * e[None, :, None]).sum(-1) + uk[:, :, kk]
                  + eb[None, :, None]) * scale                      # (B, H, TQ, OC)
            j = i0 + r + oa + x
            live = (i0 + r < tlen) & (x < nx) & (j >= 0) & (j < tlen)
            m_new = torch.maximum(m, torch.where(live, sc, NEG).amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(live, torch.exp(sc - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            m = m_new
            acc = acc * alpha[..., None] + (p[..., None] * v_tile[:, :, kk]).sum(-2)
        out[:, :, i0:i0 + n_own] = (acc / l[..., None])[:, :, :n_own]
        lse[:, :, i0:i0 + n_own] = (m + torch.log(l))[:, :, :n_own]
    return out.transpose(1, 2), lse


def _inputs(shape, tlen, seed):
    b, h, dh = shape
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)
    return (mk(b, tlen, h, dh), mk(b, tlen, h, dh), mk(b, tlen, h, dh),
            mk(tlen, h, dh), mk(h, dh), mk(tlen, h))


@functools.lru_cache(maxsize=None)
def _references(shape, tlen, band):
    """Inputs, the plain version's output and band-masked row log-sum-exp,
    and the Pallas kernel's output (interpret mode)."""
    args = _inputs(shape, tlen, seed=tlen + shape[2] + 7 * band[0] + band[1])
    ta = [t(x) for x in args]
    plain = banded_attention_plain(*ta, *band)
    scores = rel_attention_scores(ta[0], ta[1], *ta[3:])
    scores = scores.masked_fill(context_mask(tlen, *band), -torch.inf)
    lse = torch.logsumexp(scores, dim=-1)
    pallas = np.asarray(jax_banded(*map(jnp.asarray, args), *band, interpret=True))
    return args, plain, lse, pallas


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%dH%dDh%d" % s)
@pytest.mark.parametrize("band", BANDS, ids=lambda b: "band%d_%d" % b)
@pytest.mark.parametrize("tlen", T_VALUES)
def test_emulated_schedule_matches_plain_and_jax(shape, band, tlen):
    args, plain, lse_ref, pallas = _references(shape, tlen, band)
    out, lse = emulate_banded_fwd(*map(t, args), *band)
    assert not out.isnan().any() and not lse.isnan().any(), "an entry was never written"
    np.testing.assert_allclose(out.numpy(), plain.numpy(), err_msg="out vs plain", **TOL)
    np.testing.assert_allclose(out.numpy(), pallas, err_msg="out vs jax", **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), err_msg="lse", **TOL)


@pytest.mark.parametrize("band", BANDS, ids=lambda b: "band%d_%d" % b)
@pytest.mark.parametrize("tlen", [1, 33, 150])
def test_each_band_cell_is_scored_once(band, tlen):
    """Over all blocks and the chunks they work on, every live cell (i, o)
    is scored by exactly one block and chunk, its key lies in the chunk's
    staged window and its table row among the chunk's OC rows; no chunk a
    block works on is all dead."""
    left, right = band
    count = torch.zeros(tlen, left + right + 1, dtype=torch.int64)
    for i0 in range(0, tlen, TQ):
        for oa, nx in chunks(i0, tlen, left, right):
            n_live = 0
            for i in range(i0, min(i0 + TQ, tlen)):
                for o in range(oa, oa + nx):
                    j = i + o
                    if 0 <= j < tlen:
                        assert 0 <= j - (i0 + oa) < NK and 0 <= o - oa < OC
                        count[i, o + left] += 1
                        n_live += 1
            assert n_live > 0, (i0, oa)
    i = torch.arange(tlen)[:, None]
    o = torch.arange(-left, right + 1)[None]
    live = (i + o >= 0) & (i + o < tlen)
    assert torch.equal(count, live.long())
