"""PyTorch port: the schedule of the band beta kernel
(``csrc/rnnt_pruned.cu``: ``band_transfer``, ``band_rows``, in the beta's
direction), proved on the CPU.

The CUDA kernel cannot run here, so this file emulates its three phases in
plain PyTorch.  Each sequence's steps are its rows tf, tf - 1, .., 0 (step u
on row tf - u), cut into the C chunks ``chunk_row`` gives (n = tf + 1 = C q
+ rem steps, the first rem chunks q + 1 long; where tf + 1 < C the last
chunks are empty, their transfer matrices the identity); C is the count the
host asks for, cut to T:

* phase A: chunk 0 starts from the terminal injection (e_sf plus lp_b of
  row tf), gives its rows and its end state E_0; each chunk c >= 1 runs its
  steps from every unit vector e_k as the state of the step before it, and
  its end states are the columns of its transfer matrix P_c;
* phase B: E_c = max(NEG, P_c (x) E_{c-1}), at S <= 32 in the kernel's two
  levels over groups of boundaries, one boundary after another beyond;
* phase C: each chunk c >= 1 runs its steps again from E_{c-1};
* rows past tf are NEG.

A step is the kernel's: the blank edge from slot s - d[t] of the row after
(NEG for a shift outside [0, S)), lp_b[t] added where it lands, then the
row's label chain down the slots, as a scan at S <= 32 (slot by slot
beyond).  A state is held as a float64 offset plus float32 values near 0:
every 8th step of a chunk, and before phase C's steps, the largest value
moves into the offset.  The result is held against the port's plain version
and the JAX package's Pallas kernel in interpret mode on the same numpy
inputs, over chunk counts 1, 2, 7, T and the plan's own: reachable cells
within ``TOL`` (rtol 1e-5, atol 1e-3, the kernel's contract on the card),
cells at or below NEG compared with both sides clamped at NEG, and the same
cells at or below NEG / 2 on both sides.  The six sequences end at T - 1,
at 0 (no labels: a zero-length sequence), at T - 1 with the shifts -1 and
S, where tf + 1 is a multiple of C (every chunk q long), where tf + 1 < C
(empty chunks), and at T // 2 with sf clamped at S - 1.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.ops.pallas.band_kernel import band_beta_pallas
from transformer_transducer_tpu_torch.ops.cuda.band_kernel import (
    band_alpha_plan, band_beta_plain)
from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import NEG

from torch_port_helpers import band_problem, band_steps, boundaries, renorm
from torch_port_helpers import t as tt

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-3)
LENGTHS = (1, 2, 37, 410)
WIDTHS = (1, 2, 5, 33)


def beta_problem(tlen, s_range, n_chunks):
    """(lp_b, lp_l, d_beta, tf, sf) as numpy for the six sequences above
    (``band_problem``'s grids, shifts and lengths; ``d_beta[:, t] = rs[t+1]
    - rs[t]``), sf the terminal slot clamped to the band."""
    lp_b, lp_l, d, rs, u_len = band_problem(tlen, s_range, b=6)
    d_beta = np.concatenate([d[:, 1:], np.zeros_like(d[:, :1])], axis=1)
    n = min(n_chunks, tlen)
    tf = np.array([tlen - 1, 0, tlen - 1, tlen // n * n - 1, max(0, n - 2), tlen // 2])
    u_len[5] += 3 * s_range
    sf = np.clip(u_len - rs[np.arange(6), tf], 0, s_range - 1)
    return lp_b, lp_l, d_beta, tf.astype(np.int32), sf.astype(np.int32)


def beta_chunks(tf, n_chunks):
    """Each chunk's rows, in step order: steps [r0, r1) of the tf + 1, on
    rows tf - r0 .. tf - r1 + 1 (``chunk_row``; empty past tf + 1)."""
    q, rem = divmod(tf + 1, n_chunks)
    starts = [c * q + min(c, rem) for c in range(n_chunks + 1)]
    return [[tf - u for u in range(r0, r1)] for r0, r1 in zip(starts[:-1], starts[1:])]


def chunked_beta(lp_b, lp_l, d, tf, sf, n_chunks):
    """The kernel's schedule, sequence by sequence: phases A, B and C over
    the chunks of its steps, rows past tf at NEG."""
    b, tlen, s_range = lp_b.shape
    n_chunks = min(n_chunks, tlen)
    unit = torch.full((s_range, s_range), NEG).fill_diagonal_(0.0)
    out = torch.full((b, tlen, s_range), NEG)
    for i in range(b):
        chunks = beta_chunks(int(tf[i]), n_chunks)
        seq = (lp_b[i:i + 1], lp_l[i:i + 1], d[i:i + 1])
        # phase A: chunk 0 from e_sf, the others from the unit vectors
        start = unit[int(sf[i])].view(1, 1, s_range)
        first, a, k_off = band_steps(start, *seq, chunks[0], start=True, beta=True)
        out[i, chunks[0]] = first[0, 0]
        e0 = (k_off[..., None] + a.double()).float()[:, 0]
        transfer = [band_steps(unit.expand(1, s_range, s_range), *seq, rows, beta=True)
                    for rows in chunks[1:]]
        transfer = [(k_off[..., None] + a.double()).float() for _, a, k_off in transfer]
        # phase B
        ends = boundaries(e0, transfer[:-1], n_chunks if s_range <= 32 else None)
        # phase C, each chunk from its end state, renormalised first
        for e, rows in zip(ends, chunks[1:]):
            a, k_off = renorm(e[:, None], torch.zeros(1, 1, dtype=torch.float64))
            out[i, rows] = band_steps(a, *seq, rows, k_off, beta=True)[0][0, 0]
    return out


@functools.lru_cache(maxsize=None)
def references(tlen, s_range, n_chunks):
    """The plain version's and the Pallas kernel's (interpret mode) betas."""
    args = beta_problem(tlen, s_range, n_chunks)
    plain = band_beta_plain(*map(tt, args)).numpy()
    pallas = np.asarray(band_beta_pallas(*map(jnp.asarray, args), s_range, True))
    return plain, pallas


def assert_beta_close(got, want, what):
    np.testing.assert_allclose(np.maximum(got, NEG), np.maximum(want, NEG), **TOL,
                               err_msg=what)
    np.testing.assert_array_equal(got <= NEG / 2, want <= NEG / 2,
                                  err_msg=f"{what}: cells at or below NEG / 2")


@pytest.mark.parametrize("n_chunks", [1, 2, 7, "T", "plan"])
@pytest.mark.parametrize("s_range", WIDTHS)
@pytest.mark.parametrize("tlen", LENGTHS)
def test_chunked_schedule_matches_plain_and_pallas(tlen, s_range, n_chunks):
    n = {"T": tlen, "plan": band_alpha_plan(tlen, s_range)}.get(n_chunks, n_chunks)
    lp_b, lp_l, d, tf, sf = beta_problem(tlen, s_range, n)
    got = chunked_beta(tt(lp_b), tt(lp_l), tt(d), tf, sf, n).numpy()
    plain, pallas = references(tlen, s_range, n)
    assert got.shape == plain.shape == (6, tlen, s_range)
    assert_beta_close(got, plain, f"T={tlen} S={s_range} C={n} vs plain")
    assert_beta_close(got, pallas, f"T={tlen} S={s_range} C={n} vs Pallas")
    # rows past each tf sit at NEG, to the bit of the plain sweep
    for i, f in enumerate(tf):
        assert (got[i, f + 1:] == np.float32(NEG)).all()
        np.testing.assert_array_equal(got[i, f + 1:], plain[i, f + 1:])
    # the zero-length sequence: its terminal blank alone
    assert got[1, 0, 0] == lp_b[1, 0, 0] and (got[1, 0, 1:] <= NEG / 2).all()


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 7, 73, 410])
@pytest.mark.parametrize("tf", [0, 1, 5, 6, 36, 72, 409])
def test_chunks_cover_the_terminal_rows_once(tf, n_chunks):
    """C chunks whatever tf: the rows tf .. 0 once, descending, the longest
    chunk first and holding tf; past tf + 1 steps, empty chunks."""
    chunks = beta_chunks(tf, n_chunks)
    assert len(chunks) == n_chunks
    assert [t for rows in chunks for t in rows] == list(range(tf, -1, -1))
    lengths = [len(rows) for rows in chunks]
    assert chunks[0][0] == tf and lengths[0] == -(-(tf + 1) // n_chunks)
    assert max(lengths) - min(lengths) <= 1 and lengths == sorted(lengths, reverse=True)
    assert lengths.count(0) == max(0, n_chunks - tf - 1)
