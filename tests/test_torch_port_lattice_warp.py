"""PyTorch port: the schedule of the lattice sweeps' kernels
(``csrc/rnnt_lattice.cu``, ``wavefront<K, MULTI, BETA>``), proved on the CPU.

The CUDA kernels cannot run here, so this file emulates their schedule in
plain PyTorch and holds it against the plain sweeps with ``torch.equal``,
and against the JAX package's scans and Pallas kernels (interpret mode) at
rtol 1e-5 / atol 1e-3, on the same numpy inputs:

* the layout: one warp of 32 lanes up to U1 = 128, lane l holding the K
  cells u = K l .. K l + K - 1 (K the least of 1, 2, 4 with 32 K >= U1);
  above, W = ceil(U1 / 64) warps of K = 2, lane l of warp w holding
  u = 2 (32 w + l) and the next; the beta's cells past U1 hold NEG, the
  alpha's hold NaN here (the kernel leaves them unspecified), so a pad
  cell that fed a live one would show;
* a cell's neighbour on the diagonal before: the lane's own next (beta) or
  previous (alpha) register, or for one cell a lane the shuffle, a shift of
  the lanes by one, lane 31 (beta) or lane 0 (alpha) taking the next or
  previous warp's edge cell (NEG past the ends);
* the ring: the grids staged P diagonals a stage (8 for one warp, 2 for
  several), NSTAGE stages, each stage of a grid one flat span of its rows
  inside [0, D - 1) copied item by item as ``Span`` does (16-byte items
  aligned on both sides) into its slot at the span's float alignment, from
  grids whose sequences start at every alignment mod 4; a stage's inputs
  read from the ring into registers before its steps, the slot then
  refilled with the stage NSTAGE on; the ring holds NaN until copied, so a
  slot reused too early or a wrong offset would show; the last stage's
  steps past D - 1 store nothing;
* the beta's inject rule: a warp whose inject cells of the stage's rows
  are all NEG takes max(x, NEG) in place of the third log-add; its cells
  past U1 take NEG inputs, which keep them at NEG with no select.

The arithmetic runs on (B, U1) rows laid out as the plain sweeps lay them
out, so each float operation meets the same operands in the same order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.ops import rnnt_loss as J
from transformer_transducer_tpu.ops.pallas.rnnt_kernel import (
    alpha_scan_pallas, beta_scan_pallas)
from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import (
    NEG, alpha_scan_plain, beta_scan_plain, logaddexp)

from torch_port_helpers import copy_items, lattice_problem

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-3)
WIDTHS = (1, 2, 9, 31, 32, 33, 43, 64, 65, 128, 129)
LENGTHS = (1, 2, 37)
NSTAGE = 4
ALIGN = (0, 1, 3)          # each grid's float index mod 4 at its first cell


def layout(u1):
    """(K, W, P): cells a lane, warps a sequence, diagonals a stage."""
    k = 1 if u1 <= 32 else 2 if u1 <= 64 else 4 if u1 <= 128 else 2
    w = -(-u1 // (32 * k))
    return k, w, 8 if w == 1 else 2


def slot_floats(p, u1):
    return (p * u1 + 6) & ~3


def copies_a_thread(p, k):
    """The kernel's ITEMS: a stage's copies a thread at most."""
    return (p * 8 * k + 37) // 32


def to_lanes(row, k, w, pad):
    """(B, U1) -> (B, W, 32, K), ``pad`` past U1."""
    b, u1 = row.shape
    return torch.cat([row, torch.full((b, 32 * k * w - u1), pad)], dim=-1).view(b, w, 32, k)


def from_above(x):
    """The beta's u + 1 of each cell: the lane's next register, for its
    last cell lane l + 1's first (__shfl_down_sync; lane 31 keeps its own,
    then takes the next warp's lane 0, NEG past the last warp)."""
    first = x[..., 0]
    edge = torch.cat([first[:, 1:, 0], torch.full_like(first[:, :1, 0], NEG)], dim=1)
    shfl = torch.cat([first[..., 1:], edge[..., None]], dim=-1)
    return torch.cat([x[..., 1:], shfl[..., None]], dim=-1)


def from_below(x):
    """The alpha's u - 1 of each cell: the lane's previous register, for
    its first cell lane l - 1's last (__shfl_up_sync; lane 0 keeps its own,
    or with several warps takes the previous warp's lane 31, NEG in warp 0;
    the cell u = 0 has no label edge whatever it holds)."""
    last = x[..., -1]
    shfl = torch.cat([last[..., :1], last[..., :-1]], dim=-1)
    if x.shape[1] > 1:
        edge = torch.cat([torch.full_like(last[:, :1, 0], NEG), last[:, :-1, -1]], dim=1)
        shfl = torch.cat([edge[..., None], shfl[..., 1:]], dim=-1)
    return torch.cat([shfl[..., None], x[..., :-1]], dim=-1)


class Ring:
    """One sequence's ring in shared memory, NaN until copied.  Stage k
    holds the steps [k P, k P + P): rows [lo, lo + P), lo = k P (alpha) or
    n - (k + 1) P (beta), those inside [0, n) copied, row r at (r - lo) U1
    past the stage's start, which sits in slot k % NSTAGE of each grid at
    the float alignment of row lo of the grid."""

    def __init__(self, grids, aligns, n, u1, p, k, w, beta):
        self.grids, self.aligns, self.n, self.u1, self.p, self.beta = (
            grids, aligns, n, u1, p, beta)
        self.items = copies_a_thread(p, k) * 32 * w
        self.slot = slot_floats(p, u1)
        self.mem = torch.full((NSTAGE * len(grids) * self.slot,), float("nan"))

    def lo(self, k):
        return self.n - (k + 1) * self.p if self.beta else k * self.p

    def start(self, k, g):
        """Where stage k's row lo of grid g sits."""
        return (((k % NSTAGE) * len(self.grids) + g) * self.slot
                + (self.aligns[g] + self.lo(k) * self.u1) % 4)

    def stage(self, k):
        lo = self.lo(k)
        v0, v1 = max(lo, 0), min(lo + self.p, self.n)
        for g, src in enumerate(self.grids):
            dst = self.start(k, g) + (v0 - lo) * self.u1
            s0 = v0 * self.u1
            assert (self.start(k, g) - (k % NSTAGE * len(self.grids) + g) * self.slot
                    + self.p * self.u1 <= self.slot)
            items = copy_items(max(0, v1 - v0) * self.u1, (self.aligns[g] + s0) % 4)
            assert len(items) <= self.items
            for e, width in items:
                if width == 4:
                    assert (dst + e) % 4 == 0 and (self.aligns[g] + s0 + e) % 4 == 0
                self.mem[dst + e:dst + e + width] = src[s0 + e:s0 + e + width]

    def read(self, k, g, s, cells):
        """Step s of stage k: row lo + s (alpha) or lo + P - 1 - s (beta)."""
        at = (self.p - 1 - s if self.beta else s) * self.u1
        return self.mem[self.start(k, g) + at + cells]


def warp_sweep(sb, sl, inject=None):
    """The kernel's sweep (the beta given ``inject``), stage by stage and
    step by step: its diagonals of all sequences (B, D, U1)."""
    beta = inject is not None
    b, d_total, u1 = sb.shape
    k, w, p = layout(u1)
    n = d_total - 1
    grids = [sb, sl] + ([inject] if beta else [])
    rings = [Ring([x[i].reshape(-1) for x in grids],
                  [(a + i * d_total * u1) % 4 for a in ALIGN], n, u1, p, k, w, beta)
             for i in range(b)]
    cells = torch.arange(32 * k * w)
    uc = cells.clamp(max=u1 - 1)
    ul = uc if beta else (cells - 1).clamp(0, u1 - 1)
    live = cells < u1
    pad = NEG if beta else float("nan")

    out = torch.empty(b, d_total, u1)
    if beta:
        first = inject[:, n]
    else:
        first = torch.full((b, u1), NEG)
        first[:, 0] = 0.0
    out[:, n if beta else 0] = first
    x = to_lanes(first, k, w, pad)

    for kk in range(NSTAGE):
        for ring in rings:
            ring.stage(kk)
    for kk in range(-(-n // p)):
        # the stage into registers: each step's rows (B, 32 K W) and vote
        regs = [[torch.stack([ring.read(kk, g, s, ul if g == 1 else uc) for ring in rings])
                 for g in range(len(grids))] for s in range(p)]
        for ring in rings:          # the slot refilled
            ring.stage(kk + NSTAGE)
        if beta:    # the warps whose stage holds a live inject cell
            vote = torch.stack([(r[2] != NEG) & live for r in regs]).view(
                p, b, w, 32 * k).any(-1).any(0)
            lae_inject = vote[:, torch.arange(32 * k * w) // (32 * k)]
        for s, (cb, cl, *ci) in enumerate(regs):
            i = kk * p + s
            cb, cl = cb[:, :u1].contiguous(), cl[:, :u1].contiguous()
            xf = x.reshape(b, -1)[:, :u1]
            if beta:
                nb = from_above(x).reshape(b, -1)
                y = logaddexp(cb + xf, cl + nb[:, :u1])
                q = ci[0][:, :u1].contiguous()
                y = torch.where(lae_inject[:, :u1], logaddexp(y, q), torch.maximum(y, q))
                # the cells past U1 run on NEG inputs, which keep them at NEG
                neg = torch.full_like(nb[:, u1:], NEG)
                pad_y = logaddexp(neg + x.reshape(b, -1)[:, u1:], neg + nb[:, u1:])
                pad_y = torch.where(lae_inject[:, u1:], logaddexp(pad_y, neg),
                                    torch.maximum(pad_y, neg))
                assert (pad_y == NEG).all()
            else:
                left = from_below(x).reshape(b, -1)[:, :u1]
                label = torch.where(torch.arange(u1) == 0, torch.tensor(NEG), left + cl)
                y = logaddexp(xf + cb, label)
            if i < n:
                out[:, n - 1 - i if beta else i + 1] = y
            x = to_lanes(y, k, w, pad)
    return out


@functools.lru_cache(maxsize=None)
def problem(tlen, u1):
    """The inputs, the plain sweeps' outputs and the JAX package's (its
    scans and its Pallas kernels in interpret mode) on them."""
    sb, sl, terminal, inject = lattice_problem(tlen, u1)
    js = [jnp.asarray(x.numpy()) for x in (sb, sl, inject)]
    refs = {
        "alpha": (alpha_scan_plain(sb, sl),
                  [np.asarray(J._alpha_scan(*js[:2])),
                   np.asarray(alpha_scan_pallas(*js[:2], interpret=True))]),
        "beta": (beta_scan_plain(sb, sl, inject),
                 [np.asarray(J._beta_scan(*js[:2], jnp.asarray(terminal.numpy()))),
                  np.asarray(beta_scan_pallas(*js, interpret=True))]),
    }
    return (sb, sl, inject), refs


def check(sweep, tlen, u1):
    (sb, sl, inject), refs = problem(tlen, u1)
    got = warp_sweep(sb, sl, inject if sweep == "beta" else None)
    plain, (scan, pallas) = refs[sweep]
    assert got.shape == plain.shape == (4, tlen + u1 - 1, u1)
    assert torch.equal(got, plain), (
        f"{sweep} U1={u1} T={tlen}: {(got - plain).abs().max()} from the plain sweep")
    for name, ref in (("JAX scan", scan), ("Pallas", pallas)):
        np.testing.assert_allclose(got.numpy(), ref, **TOL,
                                   err_msg=f"{sweep} U1={u1} T={tlen} vs {name}")


@pytest.mark.parametrize("sweep", ["alpha", "beta"])
@pytest.mark.parametrize("u1", WIDTHS)
@pytest.mark.parametrize("tlen", LENGTHS)
def test_warp_schedule_matches_plain_and_jax(sweep, tlen, u1):
    check(sweep, tlen, u1)


@pytest.mark.parametrize("u1", [9, 43, 129])
def test_warp_beta_with_inject_inside_the_lattice(u1):
    """An inject grid (a full grid, as the kernel takes it) with cells on
    live diagonals, where lae(x, inject) is not max(x, inject): the warps
    that hold one take the log-add.  (The loss's own inject sits on each
    sequence's terminal cell, where x is NEG and the two agree.)"""
    (sb, sl, _), _ = problem(37, u1)
    mask = torch.from_numpy(np.random.RandomState(u1).rand(*sb.shape) < 0.05)
    inject = torch.where(mask, sb, torch.tensor(NEG))
    got = warp_sweep(sb, sl, inject)
    plain = beta_scan_plain(sb, sl, inject)
    assert not torch.equal(plain, beta_scan_plain(sb, sl, torch.full_like(inject, NEG)))
    assert torch.equal(got, plain)
    js = [jnp.asarray(x.numpy()) for x in (sb, sl, inject)]
    for ref in (J._beta_scan(*js[:2], jnp.asarray(mask.numpy())),
                beta_scan_pallas(*js, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("u1", [1, 31, 32, 33, 64, 65, 128, 129, 1000, 1024])
@pytest.mark.parametrize("sweep", ["alpha", "beta"])
def test_layout_ring_and_copies_fit(sweep, u1):
    """K and W cover U1, one warp up to 128; the ring fits a block's shared
    memory at every U1 the kernels take; a stage's copies never exceed
    ITEMS a thread, at every alignment and in a partial stage."""
    k, w, p = layout(u1)
    assert 32 * k * (w - 1) < u1 <= 32 * k * w and (w == 1) == (u1 <= 128)
    n_grids = 3 if sweep == "beta" else 2
    assert NSTAGE * n_grids * slot_floats(p, u1) * 4 + 2 * 16 * 4 <= 227 * 1024
    for shift in range(4):
        for rows in range(1, p + 1):
            assert len(copy_items(rows * u1, shift)) <= copies_a_thread(p, k) * 32 * w


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_copy_span_items_cover_each_float_once(shift):
    """copy_span's items cover [0, n) once, in order, the 16-byte ones on
    16-byte addresses, at every length and alignment."""
    for n in list(range(0, 40)) + [43 * 8, 129 * 8, 1024 * 2]:
        items = copy_items(n, shift)
        floats = [e + i for e, width in items for i in range(width)]
        assert sorted(floats) == list(range(n))
        assert all((shift + e) % 4 == 0 for e, width in items if width == 4)
        assert sum(width == 1 for _, width in items) <= 6


def test_lae_with_neg_is_max_to_the_bit():
    """lae(x, NEG) == max(x, NEG) to the bit in float32: exp(-|x - NEG|) is
    0, or x is NEG and NEG + log1p(1) rounds back to NEG."""
    r = np.random.RandomState(0)
    neg = np.float32(NEG)
    x = np.concatenate([
        r.uniform(-3000, 3000, 200_000).astype(np.float32),
        np.array([neg, 2 * neg, np.nextafter(neg, np.float32(0)),
                  np.nextafter(neg, np.float32(-np.inf)), np.float32(-1e29)], np.float32)])
    x = torch.from_numpy(x)
    negs = torch.full_like(x, NEG)
    got = logaddexp(x, negs)
    want = torch.maximum(x, negs)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # and with the operands the other way round
    assert torch.equal(logaddexp(negs, x).view(torch.int32), want.view(torch.int32))
