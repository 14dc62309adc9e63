"""Pruned RNN-T loss: the joint on a band of label positions around the
alignment (port of ``ops/rnnt_loss_pruned.py``).

The full joint is ``act(enc @ W_e + dec @ W_d + b1) @ W_out + b_out``.  The
pruned loss evaluates it only at ``u in [rs[t], rs[t] + s_range)`` for each
frame t, in three stages:

1. **Simple (linearized) joint.** Without the activation the joint is
   additive, ``A[t] + L[u]`` with ``A = (enc @ W_e) @ W_out`` and
   ``L = (dec @ W_d + b1) @ W_out + b_out`` (no extra parameters), so the
   (B, T, U+1) log-prob grids need two thin products, two gathers and the
   normalizer ``logsumexp_v(A[t] + L[u])`` (``ops/cuda/logz_kernel.py``).
2. **Pruning bounds.** One alpha + beta sweep of the simple lattice (the
   full-lattice kernels of ``ops/cuda/rnnt_kernel.py``) gives its loss and
   occupancy posteriors; their per-frame centre becomes monotone band
   starts ``rs`` (B, T) with steps in [0, s_range - 1], ``rs[:, 0] = 0`` and
   the terminal cell in the last band.  No gradient.
3. **Banded joint + band DP.** The real joint on the band only (T-chunked
   under ``torch.utils.checkpoint`` like ``fused_grid_logprobs``), then the
   band DP over T (``ops/cuda/band_kernel.py``) with an analytic backward.

On a CUDA tensor the logZ, full-lattice and band sweeps launch their
kernels; on a CPU tensor the same functions take the plain versions.  With
``s_range >= U+1`` the band is the whole grid and the loss equals
:func:`ops.rnnt_loss.rnnt_loss_fused`; a narrower band upper-bounds the full
NLL (pruning drops paths).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from transformer_transducer_tpu_torch.ops.activations import ACTIVATIONS
from transformer_transducer_tpu_torch.ops.precision import to_compute, widen
from transformer_transducer_tpu_torch.parallel.tensor import (
    copy_to_model, reduce_from_model, row_product)
from transformer_transducer_tpu_torch.ops.cuda.band_kernel import (
    band_alpha, band_beta)
from transformer_transducer_tpu_torch.ops.cuda.logz_kernel import additive_logz
from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import NEG, logaddexp
from transformer_transducer_tpu_torch.ops.rnnt_loss import (
    _pad_labels, _reduce, rnnt_bwd, rnnt_fwd)



# ---------------------------------------------------------------------------
# Stage 1: linearized-joint log-prob grids
# ---------------------------------------------------------------------------

def simple_grid_logprobs(enc: torch.Tensor, dec: torch.Tensor, jp,
                         labels: torch.Tensor, blank: int = 0,
                         compute_dtype: torch.dtype = torch.float32, tp=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blank/label log-prob grids (each (B, T, U+1)) of the linearized joint
    ``A[t] + L[u]`` (no activation).  Under bf16, JAX's promotion: A is a
    bf16 chain cast to float32; the float32 ``b1`` promotes L to a float32
    product over bf16-rounded ``w_out``.  The logZ takes float32 grids.
    ``tp``: a tensor-parallel joint's mesh: both grids' products by
    ``w_out`` are summed over the model group before ``b_out``, so the
    logZ runs on whole, replicated grids."""
    w_enc, w_dec, b1, w_out, b_out = jp
    cd = compute_dtype
    enc, dec = copy_to_model(enc, tp), copy_to_model(dec, tp)
    a_grid = widen(row_product(to_compute(enc, cd) @ to_compute(w_enc, cd), w_out,
                               tp, cd))                                 # (B, T, V)
    l_grid = reduce_from_model((to_compute(dec, cd) @ to_compute(w_dec, cd) + b1)
                               @ widen(to_compute(w_out, cd)), tp) + b_out  # (B, U1, V)
    b, t, _ = a_grid.shape
    u1 = dec.shape[1]
    labels_pad = _pad_labels(labels, u1, blank)
    log_z = additive_logz(a_grid, l_grid)                   # (B, T, U1)
    a_lab = torch.gather(a_grid, 2, labels_pad[:, None, :].expand(b, t, u1))
    l_lab = torch.gather(l_grid, 2, labels_pad[:, :, None])[..., 0]
    lp_b = (a_grid[..., blank][:, :, None] + l_grid[..., blank][:, None, :]
            - log_z)
    lp_l = a_lab + l_lab[:, None, :] - log_z
    return lp_b, lp_l


# ---------------------------------------------------------------------------
# Stage 2: pruning bounds
# ---------------------------------------------------------------------------

class _SimpleLossAndOcc(torch.autograd.Function):

    @staticmethod
    def forward(ctx, lp_b, lp_l, t_len, u_len):
        losses, res = rnnt_fwd(lp_b, lp_l, t_len, u_len)
        # the grids' gradients for g = 1: exactly minus the occupancies
        d_b, d_l = rnnt_bwd(res, torch.ones_like(losses))
        occ = -(d_b + d_l)
        ctx.mark_non_differentiable(occ)
        ctx.save_for_backward(d_b, d_l)
        return losses, occ

    @staticmethod
    def backward(ctx, g_loss, _g_occ):
        d_b, d_l = ctx.saved_tensors
        g = g_loss[:, None, None]
        return d_b * g, d_l * g, None, None


def simple_loss_and_occ(lp_b: torch.Tensor, lp_l: torch.Tensor, t_len,
                        u_len) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simple-lattice NLL (B,) and occupancy posteriors (B, T, U+1) from one
    alpha + beta sweep.  The occupancies are not differentiable; they are
    also the saved residual of the loss's gradient."""
    return _SimpleLossAndOcc.apply(lp_b, lp_l, t_len, u_len)


@torch.no_grad()
def bounds_from_occ(occ: torch.Tensor, t_len: torch.Tensor, u_len: torch.Tensor,
                    s_range: int) -> torch.Tensor:
    """Band starts ``rs`` (B, T) int64 from occupancy posteriors.

    By construction: ``rs[:, 0] == 0``; ``0 <= rs[:, t+1] - rs[:, t] <=
    s_range - 1``; ``rs[:, t_len-1] + s_range > u_len`` (the terminal cell
    is in the last band, feasibility permitting); ``rs <= max(0, u_len -
    s_range + 1)``.  ``torch.round`` rounds half to even, as ``jnp.round``."""
    b, t, u1 = occ.shape
    dev = occ.device
    t_len = torch.as_tensor(t_len, device=dev).long()
    u_len = torch.as_tensor(u_len, device=dev).long()
    u_idx = torch.arange(u1, dtype=torch.float32, device=dev)
    tot = occ.sum(-1)
    center = (occ * u_idx).sum(-1) / torch.clamp(tot, min=1e-6)
    u_hi = torch.clamp(u_len - (s_range - 1), min=0)          # (B,)
    raw = torch.round(center - (s_range - 1) / 2.0).long()
    # per-row lower ramp: the least start at row t that can still climb (at
    # <= s_range-1 a step) to u_hi by row t_len-1; folding it into the
    # forward clip guarantees terminal coverage by induction
    rows_left = torch.clamp((t_len - 1)[:, None]
                            - torch.arange(t, device=dev)[None, :], min=0)
    lo = torch.clamp(u_hi[:, None] - rows_left * (s_range - 1), min=0)
    raw = torch.minimum(torch.clamp(torch.maximum(raw, lo), min=0), u_hi[:, None])
    prev = torch.zeros(b, dtype=torch.long, device=dev)      # rs[0] = 0
    rows = [prev]
    for i in range(1, t):
        prev = torch.minimum(torch.maximum(raw[:, i], prev), prev + s_range - 1)
        rows.append(prev)
    return torch.stack(rows, dim=1)


def pruned_bounds(lp_b: torch.Tensor, lp_l: torch.Tensor, t_len, u_len,
                  s_range: int) -> torch.Tensor:
    """Band starts straight from simple grids (tests and diagnostics; the
    training path reuses the occupancies of ``simple_loss_and_occ``)."""
    with torch.no_grad():
        _, occ = simple_loss_and_occ(lp_b, lp_l, t_len, u_len)
    return bounds_from_occ(occ, t_len, u_len, s_range)


# ---------------------------------------------------------------------------
# Stage 3: banded joint grids + band DP
# ---------------------------------------------------------------------------

def banded_grid_logprobs(enc: torch.Tensor, dec: torch.Tensor, jp,
                         labels: torch.Tensor, rs: torch.Tensor,
                         u_len: torch.Tensor, s_range: int, blank: int = 0,
                         chunk_size: int = 32, remat: bool = True,
                         activation: str = "tanh",
                         compute_dtype: torch.dtype = torch.float32, tp=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blank/label log-prob grids on the band only (each (B, T, s_range)):
    cell (t, s) is lattice cell (t, rs[t] + s).  The real joint, with its
    activation, T-chunk by T-chunk; with ``remat`` each chunk is recomputed
    in the backward (``torch.utils.checkpoint``).  ``compute_dtype`` and
    ``tp``: as in ``ops/rnnt_loss.py::fused_grid_logprobs``."""
    w_enc, w_dec, b1, w_out, b_out = jp
    cd = compute_dtype
    b, t, _ = enc.shape
    u1 = dec.shape[1]
    dev = enc.device
    labels_pad = _pad_labels(labels, u1, blank)
    u_len = torch.as_tensor(u_len, device=dev).long()
    rs = torch.as_tensor(rs, device=dev).long()
    enc, dec = copy_to_model(enc, tp), copy_to_model(dec, tp)
    dec_proj = to_compute(dec, cd) @ to_compute(w_dec, cd) + b1     # (B, U1, inner)
    act = ACTIVATIONS[activation]
    bi = torch.arange(b, device=dev)[:, None, None]
    s_idx = torch.arange(s_range, device=dev)

    def chunk_fn(enc_chunk, rs_chunk, dec_proj, w_enc, w_out, b_out):
        uidx = rs_chunk[..., None] + s_idx                  # (B, C, S)
        uidx_c = torch.clamp(uidx, max=u1 - 1)
        h = act((to_compute(enc_chunk, cd) @ to_compute(w_enc, cd))[:, :, None, :]
                + dec_proj[bi, uidx_c])
        logits = reduce_from_model(h @ widen(to_compute(w_out, cd)), tp) + b_out  # (B, C, S, V)
        lse = torch.logsumexp(logits, dim=-1)
        lp_b = logits[..., blank] - lse
        lab = labels_pad[bi, uidx_c]
        lp_l = torch.gather(logits, -1, lab[..., None])[..., 0] - lse
        has_label = uidx < u_len[:, None, None]
        return lp_b, torch.where(has_label, lp_l, torch.full_like(lp_l, NEG))

    lp_b, lp_l = [], []
    for start in range(0, t, chunk_size):
        args = (enc[:, start:start + chunk_size], rs[:, start:start + chunk_size],
                dec_proj, w_enc, w_out, b_out)
        pb, pl = (checkpoint(chunk_fn, *args, use_reentrant=False) if remat
                  else chunk_fn(*args))
        lp_b.append(pb)
        lp_l.append(pl)
    return torch.cat(lp_b, dim=1), torch.cat(lp_l, dim=1)


def rnnt_loss_banded_grid(lp_b: torch.Tensor, lp_l: torch.Tensor, rs: torch.Tensor,
                          t_len, u_len) -> torch.Tensor:
    """Per-sequence NLL over the banded lattice, the oracle: an eager loop
    over T differentiated by autograd.

    Transitions: blank (t, u) -> (t+1, u), a band shift by ``rs[t+1] -
    rs[t]`` slots; label (t, u) -> (t, u+1), the in-row chain.  Paths that
    leave the corridor are dropped: that is the pruning."""
    lp_b = lp_b.float()
    lp_l = lp_l.float()
    b, t, s_range = lp_b.shape
    dev = lp_b.device
    rs = torch.as_tensor(rs, device=dev).long()
    t_len = torch.clamp(torch.as_tensor(t_len, device=dev).long(), max=t)
    u_len = torch.as_tensor(u_len, device=dev).long()
    # row 0 (rs[:, 0] == 0): only label emissions lead to (0, s)
    a = torch.nn.functional.pad(torch.cumsum(lp_l[:, 0, :-1], dim=-1), (1, 0))
    s_idx = torch.arange(s_range, device=dev)
    rows = [a]
    for i in range(1, t):
        prev_total = a + lp_b[:, i - 1]                     # out of row i-1
        idx = s_idx[None, :] + (rs[:, i] - rs[:, i - 1])[:, None]
        ok = (idx >= 0) & (idx < s_range)
        got = torch.gather(prev_total, 1, idx.clamp(0, s_range - 1))
        cols = list(torch.where(ok, got, torch.full_like(got, NEG)).unbind(1))
        for s in range(1, s_range):                          # in-row emissions
            cols[s] = logaddexp(cols[s], cols[s - 1] + lp_l[:, i, s - 1])
        a = torch.stack(cols, dim=1)
        rows.append(a)
    alphas = torch.stack(rows, dim=1)
    bi, tf, sf = _band_terminal(lp_b, rs, t_len, u_len)
    log_z = alphas[bi, tf, sf] + lp_b[bi, tf, sf]
    return torch.where(t_len > 0, -log_z, torch.zeros_like(log_z))


def _band_terminal(lp_b: torch.Tensor, rs: torch.Tensor, t_len: torch.Tensor,
                   u_len: torch.Tensor):
    """(bi, tf, sf): each sequence's terminal row ``tf = t_len - 1`` and slot
    ``sf``, clamped to the highest reachable slot when the corridor cannot
    climb to ``u_len`` (the truncated-sequence NLL, with live gradients)."""
    b, t, s_range = lp_b.shape
    bi = torch.arange(b, device=lp_b.device)
    tf = torch.clamp(torch.clamp(t_len, max=t) - 1, min=0)
    sf = torch.clamp(u_len - rs[bi, tf], 0, s_range - 1)
    return bi, tf, sf


class _RnntLossBanded(torch.autograd.Function):
    """The band DP's forward (alpha sweep) and analytic backward (beta sweep
    and band occupancies)."""

    @staticmethod
    def forward(ctx, lp_b, lp_l, rs, t_len, u_len):
        lp_b, lp_l = lp_b.float(), lp_l.float()
        b, t, s_range = lp_b.shape
        dev = lp_b.device
        rs = torch.as_tensor(rs, device=dev).long()
        t_len = torch.clamp(torch.as_tensor(t_len, device=dev).long(), max=t)
        u_len = torch.as_tensor(u_len, device=dev).long()
        d_steps = rs[:, 1:] - rs[:, :-1]                     # (B, T-1)
        alpha = band_alpha(lp_b, lp_l, torch.nn.functional.pad(d_steps, (1, 0)),
                           s_range)
        bi, tf, sf = _band_terminal(lp_b, rs, t_len, u_len)
        log_z = alpha[bi, tf, sf] + lp_b[bi, tf, sf]
        valid = t_len > 0
        ctx.save_for_backward(lp_b, lp_l, d_steps, alpha, log_z, tf, sf, valid)
        return torch.where(valid, -log_z, torch.zeros_like(log_z))

    @staticmethod
    def backward(ctx, g):
        lp_b, lp_l, d_steps, alpha, log_z, tf, sf, valid = ctx.saved_tensors
        b, t, s_range = lp_b.shape
        dev = lp_b.device
        beta = band_beta(lp_b, lp_l, torch.nn.functional.pad(d_steps, (0, 1)),
                         tf, sf, s_range)
        # a NEG log_z (empty or infeasible lattice) gives zero occupancies,
        # not exp(+1e30); the exponent clip also bounds float overshoot of
        # cells whose occupancy is exactly 1
        lz = torch.where(log_z > NEG / 2, log_z, torch.zeros_like(log_z))[:, None, None]
        occ = lambda x: torch.exp(torch.clamp(x - lz, max=0.0))
        neg_col = torch.full_like(beta[:, :, :1], NEG)
        # label edge (t, s) -> (t, s+1)
        occ_l = occ(alpha + lp_l + torch.cat([beta[:, :, 1:], neg_col], dim=2))
        # blank edge (t, s) -> (t+1, s - d_{t+1}); the terminal cell's blank
        # leaves the lattice (continuation log-prob 0)
        s_idx = torch.arange(s_range, device=dev)
        src = s_idx[None, None, :] - d_steps[:, :, None]     # (B, T-1, S)
        ok = (src >= 0) & (src < s_range)
        got = torch.gather(beta[:, 1:], 2, src.clamp(0, s_range - 1))
        bo = torch.cat([torch.where(ok, got, torch.full_like(got, NEG)),
                        torch.full_like(beta[:, :1], NEG)], dim=1)
        term = ((torch.arange(t, device=dev)[None, :, None] == tf[:, None, None])
                & (s_idx[None, None, :] == sf[:, None, None]))
        bo = torch.where(term, torch.zeros_like(bo), bo)
        occ_b = occ(alpha + lp_b + bo)
        gm = torch.where(valid, -g, torch.zeros_like(g))[:, None, None]
        return gm * occ_b, gm * occ_l, None, None, None


def rnnt_loss_banded(lp_b: torch.Tensor, lp_l: torch.Tensor, rs: torch.Tensor,
                     t_len, u_len) -> torch.Tensor:
    """Per-sequence banded NLL (B,), equal to :func:`rnnt_loss_banded_grid`,
    with the DP as band sweeps and an analytic backward (the JAX package's
    ``rnnt_loss_banded_pallas``).  Precondition: ``0 <= rs[:, t] -
    rs[:, t-1] <= s_range - 1``, as :func:`bounds_from_occ` guarantees; an
    out-of-range step means "no in-band source" here, where the oracle's
    guarded gather still reads the in-band sources for a negative one."""
    return _RnntLossBanded.apply(lp_b, lp_l, rs, t_len, u_len)


# ---------------------------------------------------------------------------
# End-to-end pruned loss
# ---------------------------------------------------------------------------

def rnnt_loss_pruned(enc: torch.Tensor, dec: torch.Tensor, jp, labels: torch.Tensor,
                     t_len, u_len, *, s_range: int = 5, blank: int = 0,
                     chunk_size: int = 32, reduction: str = "mean",
                     remat: bool = True, activation: str = "tanh",
                     simple_scale: float = 0.0,
                     compute_dtype: torch.dtype = torch.float32, tp=None) -> torch.Tensor:
    """Training loss with the joint evaluated only on the pruned band.

    ``simple_scale > 0`` adds that multiple of the linearized-joint NLL
    (k2's simple-loss term; here it shares the full joint's weights, so it
    also keeps the corridor estimate aligned), and its gradient flows through
    the logZ backward and the saved occupancies.  With 0 the simple pipeline
    runs without autograd: the bounds are its only consumer.
    ``compute_dtype``: bf16 joint products with JAX's promotion (see the
    stage functions); every kernel gets float32.  ``tp``: a tensor-parallel
    joint's mesh (the stage functions'): kernels 3-5 run on whole,
    replicated grids."""
    dev = enc.device
    t_len = torch.clamp(torch.as_tensor(t_len, device=dev).long(), max=enc.shape[1])
    u_len = torch.clamp(torch.as_tensor(u_len, device=dev).long(),
                        max=dec.shape[1] - 1)
    with torch.set_grad_enabled(bool(simple_scale) and torch.is_grad_enabled()):
        sp_b, sp_l = simple_grid_logprobs(enc, dec, jp, labels, blank, compute_dtype, tp)
        simple_losses, occ = simple_loss_and_occ(sp_b, sp_l, t_len, u_len)
    rs = bounds_from_occ(occ, t_len, u_len, s_range)
    lp_b, lp_l = banded_grid_logprobs(enc, dec, jp, labels, rs, u_len, s_range,
                                      blank, chunk_size, remat, activation,
                                      compute_dtype, tp)
    losses = rnnt_loss_banded(lp_b, lp_l, rs, t_len, u_len)
    if simple_scale:
        losses = losses + simple_scale * simple_losses
    return _reduce(losses, reduction)
