"""The pruned loss's band DP (alpha and beta row sweeps): CUDA kernels +
plain versions.

Replaces the TPU kernels ``ops/pallas/band_kernel.py::band_alpha_pallas``
and ``band_beta_pallas``, with their contracts: fp32 band grids ``lp_b``,
``lp_l`` (B, T, S), cell (t, s) being lattice cell (t, rs[t] + s), int32
band shifts ``d`` (B, T), and (B, T, S) outputs.

* alpha: ``d[:, t] = rs[t] - rs[t-1]`` (row 0 unused);
* beta: ``d[:, t] = rs[t+1] - rs[t]`` (last row unused) and each sequence's
  terminal row and slot ``tf``, ``sf`` (B,), injected inside the sweep, so
  rows past a sequence's end sit at NEG.

A ``d`` outside [0, S) means "no in-band source": the blank edge brings NEG,
as in the Pallas kernels (the oracle ``rnnt_loss_banded_grid`` still reads
the in-band sources for ``d < 0``).  The kernels are ``ttx_band_alpha`` /
``ttx_band_beta`` in ``csrc/rnnt_pruned.cu``, which documents the bound and
the design; they take 1 <= S <= 128 (``MAX_S``).  Both kernels cut their
rows into chunks (:func:`band_alpha_plan`, :func:`band_alpha_chunks`; the
alpha cuts T, the beta each sequence's rows [0, tf] from the top, into the
same count): each chunk's transfer matrix in parallel, a short pass over the
chunk boundaries (:func:`band_alpha_group`), then each chunk's rows again
from its true start.

Dispatch: a CPU tensor takes :func:`band_alpha_plain` / :func:`band_beta_plain`
(eager loops over T with the in-row label chain unrolled over s); a CUDA
tensor launches the kernel or raises.  The plain versions are the
functions' reference: the kernels reassociate the log-sums across chunks,
so they agree with them to rounding (cells no path reaches sit at NEG in
both).  ``band_alpha.launches`` and ``band_beta.launches`` count kernel
calls (a call is one or two launches, one kernel).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from transformer_transducer_tpu_torch.ops.cuda import build
from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import NEG, logaddexp

MAX_S = 128

# The alpha plan's cost model, in microseconds of an H100, fitted to the
# kernel's times over chunk counts (B = 4, T = 37 and 410, S = 1-128;
# ``tools/time_banded_bwd.py --pass alpha --chunks``): a row step of the
# single sweep (the gather, then the label chain: ceil(log2 S) scan steps at
# S <= 32, S - 1 steps beyond), a chunked row at 0.92 of it, a boundary step
# of phase B, and the fixed cost of the second launch.
def _row_us(s_range: int) -> float:
    if s_range <= 32:
        return 0.17 + 0.13 * (s_range - 1).bit_length()
    return 0.085 * (s_range - 1)


def _boundary_us(s_range: int) -> float:
    if s_range <= 8:
        return 0.06 + 0.072 * s_range
    if s_range <= 32:
        return 0.09 * s_range
    return 0.0045 * s_range * s_range + 0.25 * s_range


CHUNKED_ROW, SECOND_LAUNCH_US = 0.92, 5.0
# at most this many start vectors (chunks x S) a sequence in phase A
MAX_STARTS = 1024


def _shifted(x: torch.Tensor, d: torch.Tensor, sign: int) -> torch.Tensor:
    """``out[:, s] = x[:, s + sign * d]``, NEG where ``d`` is outside [0, S)
    or the source slot is."""
    s_range = x.shape[1]
    s_idx = torch.arange(s_range, device=x.device)
    src = s_idx[None, :] + sign * d[:, None]
    ok = ((d >= 0) & (d < s_range))[:, None] & (src >= 0) & (src < s_range)
    got = torch.gather(x, 1, src.clamp(0, s_range - 1))
    return torch.where(ok, got, torch.full_like(got, NEG))


def band_alpha_chunks(t: int, n_chunks: int) -> list:
    """The rows ``[(r0, r1), ...]`` of the alpha kernel's chunks: ``T = C q +
    rem`` rows, the first ``rem`` chunks ``q + 1`` long, the others ``q``; C is
    ``n_chunks`` cut to T.  ``chunk_row`` in ``csrc/rnnt_pruned.cu``."""
    n = max(1, min(n_chunks, t))
    q, rem = divmod(t, n)
    starts = [c * q + min(c, rem) for c in range(n + 1)]
    return list(zip(starts[:-1], starts[1:]))


def band_alpha_group(n_chunks: int) -> int:
    """Boundaries a group in the alpha kernel's two-level phase B: the H that
    minimises its 2 H + ceil(n / H) steps over n = C - 2 boundaries
    (``boundary_group`` in ``csrc/rnnt_pruned.cu``)."""
    n, h = n_chunks - 2, 1
    while n > 0 and 2 * (h + 1) + -(-n // (h + 1)) < 2 * h + -(-n // h):
        h += 1
    return h


def _chain_parts(t: int, n_chunks: int, s_range: int):
    """(rows, boundary steps) on a band kernel's chain with ``n_chunks``
    chunks of ``t`` rows: the longest chunk's rows twice (phases A and C);
    phase B's steps, in two levels at S <= 32 (its first level in rounds of
    the rows launch's 16 warps of 32 // W start vectors), one boundary
    after another beyond."""
    n = max(1, min(n_chunks, t))
    if n == 1:
        return t, 0
    rows = 2 * -(-t // n)
    if s_range > 32:
        return rows, n - 2
    h = band_alpha_group(n)
    g = -(-(n - 2) // h)
    per_warp = 32 // (1 << (s_range - 1).bit_length())
    warps = min(16, -(-(n - 1) // per_warp))
    rounds = -(-g * s_range // (warps * per_warp))
    return rows, (rounds * h + g + h - 1 if g else 0)


def band_chain(t: int, n_chunks: int, s_range: int) -> int:
    """Dependent steps of a band kernel with ``n_chunks`` chunks of ``t``
    rows: rows and phase B's boundary steps (t rows at C = 1).  The
    alpha's ``t`` is T; the beta's the longest sequence's tf + 1."""
    return sum(_chain_parts(t, n_chunks, s_range))


@functools.lru_cache(maxsize=None)
def band_alpha_plan(t: int, s_range: int) -> int:
    """Chunks of T for both band kernels: the C that minimises the cost model
    above over its chain, with at most ``MAX_STARTS`` start vectors a
    sequence; 1 (the plain sweep's single pass) where chunks do not pay, at
    small T."""
    row, step = _row_us(s_range), _boundary_us(s_range)

    def cost(n: int) -> float:
        rows, steps = _chain_parts(t, n, s_range)
        if n == 1:
            return rows * row
        return CHUNKED_ROW * rows * row + steps * step + SECOND_LAUNCH_US

    return min(range(1, max(1, min(t, MAX_STARTS // s_range)) + 1), key=cost)


def band_alpha_plain(lp_b: torch.Tensor, lp_l: torch.Tensor,
                     d_alpha: torch.Tensor) -> torch.Tensor:
    """Band alphas (B, T, S): a path starts at lattice (0, 0); row t takes
    the blank edges out of row t-1 shifted by ``d_alpha[:, t]``, then the
    in-row label chain ``a[s] = lae(a[s], a[s-1] + lp_l[t, s-1])``."""
    b, t_max, s_range = lp_b.shape
    rows, a = [], None
    for t in range(t_max):
        if t == 0:
            a = torch.full_like(lp_b[:, 0], NEG)
            a[:, 0] = 0.0
        else:
            a = _shifted(a + lp_b[:, t - 1], d_alpha[:, t], 1)
        cols = list(a.unbind(1))
        for s in range(1, s_range):
            cols[s] = logaddexp(cols[s], cols[s - 1] + lp_l[:, t, s - 1])
        a = torch.stack(cols, dim=1)
        rows.append(a)
    return torch.stack(rows, dim=1)


def band_beta_plain(lp_b: torch.Tensor, lp_l: torch.Tensor, d_beta: torch.Tensor,
                    tf: torch.Tensor, sf: torch.Tensor) -> torch.Tensor:
    """Band betas (B, T, S): ``beta[t, s]`` is the log-prob of finishing from
    cell (t, s), its terminal blank included.  Row t takes the blank edge to
    row t+1 (``lp_b + beta[t+1, s - d_beta[:, t]]``), or at the sequence's
    terminal row only the terminal blank at slot ``sf``; then the reverse
    label chain ``b[s] = lae(b[s], lp_l[t, s] + b[s+1])``."""
    b, t_max, s_range = lp_b.shape
    s_idx = torch.arange(s_range, device=lp_b.device)
    nxt = torch.full_like(lp_b[:, 0], NEG)
    rows = []
    for t in range(t_max - 1, -1, -1):
        lpb = lp_b[:, t]
        blank = lpb + _shifted(nxt, d_beta[:, t], -1)
        inject = torch.where(s_idx[None, :] == sf[:, None], lpb,
                             torch.full_like(lpb, NEG))
        blank = torch.where((tf == t)[:, None], inject, blank)
        cols = list(blank.unbind(1))
        for s in range(s_range - 2, -1, -1):
            cols[s] = logaddexp(cols[s], lp_l[:, t, s] + cols[s + 1])
        nxt = torch.stack(cols, dim=1)
        rows.append(nxt)
    return torch.stack(rows[::-1], dim=1)


def _check(name: str, s_range: int, lp_b: torch.Tensor, lp_l: torch.Tensor,
           d: torch.Tensor, *per_seq: torch.Tensor) -> None:
    if lp_b.dim() != 3 or lp_l.shape != lp_b.shape or lp_b.shape[2] != s_range:
        raise ValueError(f"{name}: lp_b and lp_l must share one (B, T, S = "
                         f"{s_range}) shape, got {tuple(lp_b.shape)} and "
                         f"{tuple(lp_l.shape)}")
    if lp_b.dtype != torch.float32 or lp_l.dtype != torch.float32:
        raise TypeError(f"{name}: the grids must be float32")
    if tuple(d.shape) != tuple(lp_b.shape[:2]):
        raise ValueError(f"{name}: d must be (B, T), got {tuple(d.shape)}")
    for x in per_seq:
        if tuple(x.shape) != (lp_b.shape[0],):
            raise ValueError(f"{name}: tf and sf must be (B,), got {tuple(x.shape)}")
    for x in (lp_l, d, *per_seq):
        if x.device != lp_b.device:
            raise ValueError(f"{name}: inputs on different devices")


def _inputs(lp_b, lp_l, ints):
    """Contiguous CUDA inputs, the output, the library and the stream."""
    if lp_b.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {lp_b.device}")
    s_range = lp_b.shape[2]
    if not 1 <= s_range <= MAX_S:
        raise ValueError(f"the band kernels take 1 <= S <= {MAX_S}, got {s_range}")
    lp_b, lp_l = lp_b.contiguous(), lp_l.contiguous()
    ints = [x.to(torch.int32).contiguous() for x in ints]
    stream = torch.cuda.current_stream(lp_b.device).cuda_stream
    return lp_b, lp_l, ints, torch.empty_like(lp_b), build.library(), stream


def _launch(wrapper, lp_b, lp_l, ints, n_chunks: Optional[int]) -> torch.Tensor:
    """``ttx_<wrapper's name>`` on CUDA inputs (``ints``: d, then the beta's
    tf and sf), in ``band_alpha_plan``'s chunks or, for tests and
    measurements, ``n_chunks``; counts on ``wrapper``."""
    lp_b, lp_l, ints, out, lib, stream = _inputs(lp_b, lp_l, ints)
    b, t, s_range = lp_b.shape
    if out.numel() == 0:
        return out
    n = min(n_chunks or band_alpha_plan(t, s_range), t)
    work = torch.empty(b * n * s_range * s_range, dtype=torch.float32, device=out.device)
    name = f"ttx_{wrapper.__name__}"
    build.check(getattr(lib, name)(lp_b.data_ptr(), lp_l.data_ptr(),
                                   *(x.data_ptr() for x in ints), out.data_ptr(),
                                   work.data_ptr(), b, t, s_range, n, stream), name)
    wrapper.launches += 1
    return out


def _launch_alpha(lp_b, lp_l, d_alpha, n_chunks: Optional[int] = None) -> torch.Tensor:
    """``ttx_band_alpha``; ``n_chunks`` forces the chunk count."""
    return _launch(band_alpha, lp_b, lp_l, [d_alpha], n_chunks)


def _launch_beta(lp_b, lp_l, d_beta, tf, sf, n_chunks: Optional[int] = None) -> torch.Tensor:
    """``ttx_band_beta``; ``n_chunks`` forces the chunk count."""
    return _launch(band_beta, lp_b, lp_l, [d_beta, tf, sf], n_chunks)


def band_alpha(lp_b: torch.Tensor, lp_l: torch.Tensor, d_alpha: torch.Tensor,
               s_range: int) -> torch.Tensor:
    """Band alphas (B, T, S = s_range); ``d_alpha[:, t] = rs[t] - rs[t-1]``."""
    _check("band_alpha", s_range, lp_b, lp_l, d_alpha)
    if lp_b.device.type == "cpu":
        return band_alpha_plain(lp_b, lp_l, d_alpha)
    return _launch_alpha(lp_b, lp_l, d_alpha)


def band_beta(lp_b: torch.Tensor, lp_l: torch.Tensor, d_beta: torch.Tensor,
              tf: torch.Tensor, sf: torch.Tensor, s_range: int) -> torch.Tensor:
    """Band betas (B, T, S = s_range); ``d_beta[:, t] = rs[t+1] - rs[t]``,
    terminal (row, slot) ``tf``, ``sf`` per sequence."""
    _check("band_beta", s_range, lp_b, lp_l, d_beta, tf, sf)
    if lp_b.device.type == "cpu":
        return band_beta_plain(lp_b, lp_l, d_beta, tf, sf)
    return _launch_beta(lp_b, lp_l, d_beta, tf, sf)


band_alpha.launches = 0
band_beta.launches = 0
