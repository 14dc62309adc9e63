"""The pruned loss's band DP (alpha and beta row sweeps): CUDA kernels +
plain versions.

Replaces the TPU kernels ``ops/pallas/band_kernel.py::band_alpha_pallas``
and ``band_beta_pallas``, with their contracts: fp32 band grids ``lp_b``,
``lp_l`` (B, T, S), cell (t, s) being lattice cell (t, rs[t] + s), int32
band shifts ``d`` (B, T), and (B, T, S) outputs.

* alpha: ``d[:, t] = rs[t] - rs[t-1]`` (row 0 unused);
* beta: ``d[:, t] = rs[t+1] - rs[t]`` (last row unused) and each sequence's
  terminal row and slot ``tf``, ``sf`` (B,), injected inside the sweep, so
  rows past a sequence's end stay near NEG.

A ``d`` outside [0, S) means "no in-band source": the blank edge brings NEG,
as in the Pallas kernels (the oracle ``rnnt_loss_banded_grid`` still reads
the in-band sources for ``d < 0``).  The kernels are ``ttx_band_alpha`` /
``ttx_band_beta`` in ``csrc/rnnt_pruned.cu``, which documents the bound and
the design; they take S <= 32 (one warp lane per band slot).

Dispatch: a CPU tensor takes :func:`band_alpha_plain` / :func:`band_beta_plain`
(eager loops over T with the in-row label chain unrolled over s, the same
arithmetic in the same order as the kernels); a CUDA tensor launches the
kernel or raises.  ``band_alpha.launches`` and ``band_beta.launches`` count
kernel launches.
"""

from __future__ import annotations

import torch

from transformer_transducer_tpu_torch.ops.cuda import build
from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import NEG, logaddexp

MAX_S = 128


def _shifted(x: torch.Tensor, d: torch.Tensor, sign: int) -> torch.Tensor:
    """``out[:, s] = x[:, s + sign * d]``, NEG where ``d`` is outside [0, S)
    or the source slot is."""
    s_range = x.shape[1]
    s_idx = torch.arange(s_range, device=x.device)
    src = s_idx[None, :] + sign * d[:, None]
    ok = ((d >= 0) & (d < s_range))[:, None] & (src >= 0) & (src < s_range)
    got = torch.gather(x, 1, src.clamp(0, s_range - 1))
    return torch.where(ok, got, torch.full_like(got, NEG))


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


def _launch(wrapper, fn: str, lp_b, lp_l, ints) -> torch.Tensor:
    """Kernel ``fn`` on contiguous CUDA inputs; counts on ``wrapper``."""
    if lp_b.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {lp_b.device}")
    b, t, s_range = lp_b.shape
    if not 1 <= s_range <= MAX_S:
        raise ValueError(f"the band kernels take 1 <= S <= {MAX_S}, got {s_range}")
    lp_b, lp_l = lp_b.contiguous(), lp_l.contiguous()
    ints = [x.to(torch.int32).contiguous() for x in ints]
    out = torch.empty_like(lp_b)
    if out.numel() == 0:
        return out
    lib = build.library()
    stream = torch.cuda.current_stream(lp_b.device).cuda_stream
    build.check(getattr(lib, fn)(lp_b.data_ptr(), lp_l.data_ptr(),
                                 *(x.data_ptr() for x in ints), out.data_ptr(),
                                 b, t, s_range, stream), fn)
    wrapper.launches += 1
    return out


def band_alpha(lp_b: torch.Tensor, lp_l: torch.Tensor, d_alpha: torch.Tensor,
               s_range: int) -> torch.Tensor:
    """Band alphas (B, T, S = s_range); ``d_alpha[:, t] = rs[t] - rs[t-1]``."""
    _check("band_alpha", s_range, lp_b, lp_l, d_alpha)
    if lp_b.device.type == "cpu":
        return band_alpha_plain(lp_b, lp_l, d_alpha)
    return _launch(band_alpha, "ttx_band_alpha", lp_b, lp_l, [d_alpha])


def band_beta(lp_b: torch.Tensor, lp_l: torch.Tensor, d_beta: torch.Tensor,
              tf: torch.Tensor, sf: torch.Tensor, s_range: int) -> torch.Tensor:
    """Band betas (B, T, S = s_range); ``d_beta[:, t] = rs[t+1] - rs[t]``,
    terminal (row, slot) ``tf``, ``sf`` per sequence."""
    _check("band_beta", s_range, lp_b, lp_l, d_beta, tf, sf)
    if lp_b.device.type == "cpu":
        return band_beta_plain(lp_b, lp_l, d_beta, tf, sf)
    return _launch(band_beta, "ttx_band_beta", lp_b, lp_l, [d_beta, tf, sf])


band_alpha.launches = 0
band_beta.launches = 0
