"""PyTorch port: the schedule of the band alpha kernel
(``csrc/rnnt_pruned.cu``: ``band_transfer``, ``band_rows``, in the
alpha's direction), proved on the CPU.

The CUDA kernel cannot run here, so this file emulates its three phases in
plain PyTorch, in the chunks of T that ``band_alpha_chunks`` gives:

* phase A: chunk 0 runs from row 0's start and gives its alpha rows and its
  end state E_0; each chunk c >= 1 runs its rows from every unit vector e_k
  (0 at slot k, NEG elsewhere) as the state of the row before it, and its
  end states are the columns of its transfer matrix P_c;
* phase B: E_c = max(NEG, P_c (x) E_{c-1}), the kernel's log-sum-exp (the
  largest term, then the exponentials summed over k in order), at S <= 32
  in the kernel's two levels over groups of boundaries (each group's
  composite from the unit vectors, the groups' end states one after
  another, then the states inside each group), one boundary after another
  beyond;
* phase C: each chunk c >= 1 runs its rows again from E_{c-1}.

The row step is the kernel's: the blank edge out of the row before (shifted
by ``d[t]``, NEG for a shift outside [0, S)), then the in-row label chain,
as a scan over the slots at S <= 32 (slot by slot beyond).  A state is held
as a float64 offset plus float32 values near 0: every 8th row of a chunk,
and before phase C's rows, the largest value moves into the offset.
The result is held against the port's plain version and the JAX package's
Pallas kernel in interpret mode on the same numpy inputs, over chunk counts
1, 2, 7, T and the plan's own: reachable cells within ``TOL`` (rtol 1e-5,
atol 1e-3, the kernel's contract on the card: log-alphas reach hundreds),
cells at or below NEG compared with both sides clamped at NEG, and the same
cells at or below NEG / 2 on both sides.  The inputs hold label cells past
u_len at NEG, a sequence with no labels (every label cell at NEG), and
shifts of -1 and S.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.ops.pallas.band_kernel import band_alpha_pallas
from transformer_transducer_tpu_torch.ops.cuda.band_kernel import (
    MAX_STARTS, band_alpha_chunks, band_alpha_group, band_alpha_plain, band_alpha_plan,
    band_chain)
from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import NEG

from torch_port_helpers import band_problem, band_steps, boundaries, renorm
from torch_port_helpers import t as tt

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-3)
LENGTHS = (1, 2, 37, 410)
WIDTHS = (1, 2, 5, 33)


def chunked_alpha(lp_b, lp_l, d, n_chunks):
    """The kernel's schedule: phases A, B and C over ``band_alpha_chunks``."""
    b, tlen, s_range = lp_b.shape
    chunks = band_alpha_chunks(tlen, n_chunks)
    start = torch.full((b, 1, s_range), NEG)
    start[..., 0] = 0.0
    unit = torch.full((s_range, s_range), NEG).fill_diagonal_(0.0)
    # phase A
    first = band_steps(start, lp_b, lp_l, d, range(*chunks[0]), start=True)[0][:, 0]
    transfer = [band_steps(unit.expand(b, s_range, s_range), lp_b, lp_l, d, range(r0, r1))
                for r0, r1 in chunks[1:]]
    transfer = [(k_off[..., None] + a.double()).float() for _, a, k_off in transfer]
    # phase B
    ends = boundaries(first[:, -1], transfer[:-1], n_chunks if s_range <= 32 else None)
    # phase C, each chunk from its end state, renormalised first
    rows = [first]
    for e, (r0, r1) in zip(ends, chunks[1:]):
        a, k_off = renorm(e[:, None], torch.zeros(b, 1, dtype=torch.float64))
        rows.append(band_steps(a, lp_b, lp_l, d, range(r0, r1), k_off)[0][:, 0])
    return torch.cat(rows, dim=1)


@functools.lru_cache(maxsize=None)
def references(tlen, s_range):
    """The plain version's and the Pallas kernel's (interpret mode) alphas."""
    lp_b, lp_l, d, _, _ = band_problem(tlen, s_range)
    plain = band_alpha_plain(tt(lp_b), tt(lp_l), tt(d)).numpy()
    pallas = np.asarray(band_alpha_pallas(jnp.asarray(lp_b), jnp.asarray(lp_l),
                                          jnp.asarray(d), s_range, True))
    return plain, pallas


def assert_alpha_close(got, want, what):
    np.testing.assert_allclose(np.maximum(got, NEG), np.maximum(want, NEG), **TOL,
                               err_msg=what)
    np.testing.assert_array_equal(got <= NEG / 2, want <= NEG / 2,
                                  err_msg=f"{what}: cells at or below NEG / 2")


@pytest.mark.parametrize("n_chunks", [1, 2, 7, "T", "plan"])
@pytest.mark.parametrize("s_range", WIDTHS)
@pytest.mark.parametrize("tlen", LENGTHS)
def test_chunked_schedule_matches_plain_and_pallas(tlen, s_range, n_chunks):
    n = {"T": tlen, "plan": band_alpha_plan(tlen, s_range)}.get(n_chunks, n_chunks)
    lp_b, lp_l, d, _, _ = band_problem(tlen, s_range)
    got = chunked_alpha(tt(lp_b), tt(lp_l), tt(d), n).numpy()
    plain, pallas = references(tlen, s_range)
    assert got.shape == plain.shape == (3, tlen, s_range)
    assert_alpha_close(got, plain, f"T={tlen} S={s_range} C={n} vs plain")
    assert_alpha_close(got, pallas, f"T={tlen} S={s_range} C={n} vs Pallas")
    # the sequence with no labels: no path reaches a slot past 0
    assert (got[1, :, 1:] <= NEG / 2).all() and got[1, 0, 0] == 0.0


@pytest.mark.parametrize("tlen", [1, 2, 3, 7, 37, 64, 409, 410, 411])
def test_chunks_cover_the_rows_once(tlen):
    for n in sorted({1, 2, 3, 7, tlen - 1, tlen, tlen + 5} - {0}):
        chunks = band_alpha_chunks(tlen, n)
        assert len(chunks) == min(n, tlen)
        rows = [t for r0, r1 in chunks for t in range(r0, r1)]
        assert rows == list(range(tlen))
        lengths = {r1 - r0 for r0, r1 in chunks}
        assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
        # the longest chunk first (the kernel's L = ceil(T / C) rows)
        assert chunks[0][1] - chunks[0][0] == -(-tlen // len(chunks))


@pytest.mark.parametrize("s_range", [1, 2, 5, 8, 32, 33, 64, 128])
@pytest.mark.parametrize("tlen", [1, 2, 16, 48, 410, 820])
def test_plan_bounds_and_chain(tlen, s_range):
    n = band_alpha_plan(tlen, s_range)
    assert 1 <= n <= max(1, min(tlen, MAX_STARTS // s_range))
    chain = band_chain(tlen, n, s_range)
    assert chain <= tlen
    if n == 1:
        assert chain == tlen
    elif s_range > 32:
        assert chain == 2 * -(-tlen // n) + n - 2
    else:       # two levels: fewer boundary steps than boundaries, past a few
        assert 2 * -(-tlen // n) <= chain <= 2 * -(-tlen // n) + max(n - 2, 3 * n)


@pytest.mark.parametrize("n_chunks", [2, 3, 4, 10, 17, 41, 100, 200])
def test_two_level_groups(n_chunks):
    """The group size minimises 2 H + ceil(n / H) over n = C - 2 boundaries,
    and the groups cover the boundaries once."""
    n, h = n_chunks - 2, band_alpha_group(n_chunks)
    cost = lambda x: 2 * x + -(-n // x)
    assert h >= 1 and (n == 0 or cost(h) == min(cost(x) for x in range(1, n + 1)))
