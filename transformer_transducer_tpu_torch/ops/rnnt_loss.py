"""RNN-T (transducer) loss (port of ``ops/rnnt_loss.py``).

The (T, U) lattice recursion runs along anti-diagonals: every cell on
diagonal ``d = t + u`` depends only on diagonal ``d - 1``.  The blank/label
log-prob grids are "skewed" so that the diagonals are rows, and the sweeps
(``ops/cuda/rnnt_kernel.py``: a CUDA kernel on the card, the eager scan on
the CPU) walk them.  The backward is analytic (beta sweep + occupancy
posteriors) in a ``torch.autograd.Function``, not autograd through the scan.

``fused_grid_logprobs`` computes the per-cell blank/label log-probs straight
from the encoder/label-encoder states and the joint weights, T-chunk by
T-chunk (under ``torch.utils.checkpoint`` when ``remat``), so the
(B, T, U+1, V) joint tensor never exists whole.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import (
    NEG, alpha_scan, beta_scan)
from transformer_transducer_tpu_torch.ops.activations import ACTIVATIONS
from transformer_transducer_tpu_torch.ops.precision import to_compute, widen


def _skew(lp: torch.Tensor) -> torch.Tensor:
    """(B, T, U1) -> (B, D, U1) with skew[b, d, u] = lp[b, d - u, u];
    out-of-range cells are NEG.

    The pad+reshape stride trick, not a gather: viewing the (U1, D+1)-padded
    transpose through a (U1, D) reshape re-reads each row at stride D, so
    ``flat[u*D + d] == padded[u, d - u]``, with both the tail pad and the
    d < u wrap landing in NEG padding."""
    b, t, u1 = lp.shape
    d_total = t + u1 - 1
    x = torch.nn.functional.pad(lp.transpose(1, 2), (0, d_total + 1 - t),
                                value=NEG)                    # (B, U1, D+1)
    flat = x.reshape(b, u1 * (d_total + 1))
    return flat[:, :u1 * d_total].reshape(b, u1, d_total).transpose(1, 2)


def _unskew(skewed: torch.Tensor, t: int) -> torch.Tensor:
    """Inverse of :func:`_skew`: (B, D, U1) -> (B, T, U1), reading the
    flattened (U1, D) rows at stride D+1: ``flat[u*(D+1) + tau] ==
    skewed[tau + u, u]``."""
    b, d_total, u1 = skewed.shape
    flat = skewed.transpose(1, 2).reshape(b, u1 * d_total)
    flat = torch.nn.functional.pad(flat, (0, u1))             # len U1*(D+1)
    return flat.reshape(b, u1, d_total + 1)[:, :, :t].transpose(1, 2)


def _shift_left_u(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[..., 1:], torch.full_like(x[..., :1], NEG)], dim=-1)


def _mask_label_grid(lp_l: torch.Tensor, u_len: torch.Tensor) -> torch.Tensor:
    u1 = lp_l.shape[-1]
    has_label = torch.arange(u1, device=lp_l.device)[None, :] < u_len[:, None]
    return torch.where(has_label[:, None, :], lp_l, torch.full_like(lp_l, NEG))


def lattice_grids(lp_b: torch.Tensor, lp_l: torch.Tensor, t_len, u_len):
    """The sweeps' inputs: (skew_b, skew_l, t_len, u_len), contiguous fp32
    skewed grids with the label cells past each row's ``u_len`` at NEG, and
    the lengths clamped to the grid.  Over-length rows are clamped (the
    truncated-sequence NLL, with live gradients) rather than placing the
    terminal cell off the grid."""
    b, t, u1 = lp_b.shape
    t_len = torch.clamp(torch.as_tensor(t_len).to(lp_b.device).long(), max=t)
    u_len = torch.clamp(torch.as_tensor(u_len).to(lp_b.device).long(), max=u1 - 1)
    lp_l = _mask_label_grid(lp_l.float(), u_len)
    return (_skew(lp_b.float()).contiguous(), _skew(lp_l).contiguous(),
            t_len, u_len)


def terminal_inject(skew_b: torch.Tensor, t_len: torch.Tensor,
                    u_len: torch.Tensor):
    """(terminal, inject): each row's terminal cell (d = t_len-1+u_len,
    u = u_len) as a mask, and the beta sweep's inject, the final blank
    log-prob there and NEG elsewhere."""
    b, d_total, u1 = skew_b.shape
    dev = skew_b.device
    d_final = torch.clamp(t_len - 1 + u_len, min=0)
    terminal = ((torch.arange(d_total, device=dev)[None, :, None]
                 == d_final[:, None, None])
                & (torch.arange(u1, device=dev)[None, None, :]
                   == u_len[:, None, None]))
    return terminal, torch.where(terminal, skew_b, torch.full_like(skew_b, NEG))


def rnnt_fwd(lp_b: torch.Tensor, lp_l: torch.Tensor, t_len, u_len):
    """The loss's forward (the JAX package's ``_rnnt_fwd``): per-sequence NLL
    (B,) and the residuals :func:`rnnt_bwd` takes, from one alpha sweep."""
    lp_b = lp_b.float()
    b, t, u1 = lp_b.shape
    skew_b, skew_l, t_len, u_len = lattice_grids(lp_b, lp_l, t_len, u_len)
    alpha = alpha_scan(skew_b, skew_l)
    bi = torch.arange(b, device=lp_b.device)
    # t_len == 0 rows have no lattice: a zero loss (and zero gradients)
    valid = t_len > 0
    d_final = torch.clamp(t_len - 1 + u_len, min=0)
    log_z = (alpha[bi, d_final, u_len]
             + lp_b[bi, torch.clamp(t_len - 1, min=0), u_len])
    loss = torch.where(valid, -log_z, torch.zeros_like(log_z))
    return loss, (skew_b, skew_l, alpha, log_z, t_len, u_len, t)


def rnnt_bwd(res, g: torch.Tensor):
    """The loss's analytic backward (the JAX package's ``_rnnt_bwd``): the
    gradients of the (B, T, U1) grids for the loss cotangent ``g`` (B,),
    from one beta sweep; with ``g = 1`` they are minus the occupancies."""
    skew_b, skew_l, alpha, log_z, t_len, u_len, t = res
    b, d_total, u1 = skew_b.shape
    dev = skew_b.device
    valid = t_len > 0
    terminal, inject = terminal_inject(skew_b, t_len, u_len)
    beta = beta_scan(skew_b, skew_l, inject)

    beta_next = torch.cat([beta[:, 1:], torch.full_like(beta[:, :1], NEG)],
                          dim=1)                           # beta' on d+1
    # invalid rows: a sanitized log_z (theirs may be -1e30) and a zero chain
    # scale
    lz = torch.where(valid, log_z, torch.zeros_like(log_z))[:, None, None]
    occ_b = torch.exp(alpha + skew_b + beta_next - lz)
    occ_b = occ_b + torch.where(terminal, torch.exp(alpha + skew_b - lz),
                                torch.zeros_like(occ_b))
    occ_l = torch.exp(alpha + skew_l + _shift_left_u(beta_next) - lz)

    scale = torch.where(valid, -g, torch.zeros_like(g))[:, None, None]
    d_lp_b = _unskew(occ_b * scale, t)
    d_lp_l = _unskew(occ_l * scale, t)
    # masked label columns got NEG in the forward: no gradient there
    has_label = (torch.arange(u1, device=dev)[None, None, :]
                 < u_len[:, None, None])
    d_lp_l = torch.where(has_label, d_lp_l, torch.zeros_like(d_lp_l))
    return d_lp_b, d_lp_l


class _RnntLossGrid(torch.autograd.Function):
    """Per-sequence NLL from the grids, with the analytic backward."""

    @staticmethod
    def forward(ctx, lp_b, lp_l, t_len, u_len):
        loss, res = rnnt_fwd(lp_b, lp_l, t_len, u_len)
        *tensors, ctx.t = res
        ctx.save_for_backward(*tensors)
        return loss

    @staticmethod
    def backward(ctx, g):
        return (*rnnt_bwd((*ctx.saved_tensors, ctx.t), g), None, None)


def rnnt_loss_grid(lp_b: torch.Tensor, lp_l: torch.Tensor, t_len: torch.Tensor,
                   u_len: torch.Tensor) -> torch.Tensor:
    """Per-sequence RNN-T negative log-likelihood from log-prob grids.

    Args:
      lp_b: (B, T, U+1) log P(blank | t, u).
      lp_l: (B, T, U+1) log P(y_{u+1} | t, u); column U is ignored.
      t_len, u_len: (B,) true lengths.
    Returns: (B,) losses.
    """
    return _RnntLossGrid.apply(lp_b, lp_l, t_len, u_len)


def _reduce(losses: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return losses.mean()
    if reduction == "sum":
        return losses.sum()
    return losses


def _pad_labels(labels: torch.Tensor, u1: int, blank: int) -> torch.Tensor:
    return torch.nn.functional.pad(labels.long(), (0, u1 - labels.shape[1]),
                                   value=blank)


def grid_logprobs_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                              blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,T,U+1,V) logits -> blank/label log-prob grids (each (B,T,U+1))."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    labels_pad = _pad_labels(labels, logits.shape[2], blank)
    idx = labels_pad[:, None, :, None].expand(-1, lp.shape[1], -1, -1)
    return lp[..., blank], torch.gather(lp, -1, idx)[..., 0]


def rnnt_loss(logits: torch.Tensor, labels: torch.Tensor, t_len, u_len,
              blank: int = 0, reduction: str = "mean") -> torch.Tensor:
    """The loss from full logits (``warprnnt_pytorch.RNNTLoss`` semantics)."""
    lp_b, lp_l = grid_logprobs_from_logits(logits, labels, blank)
    return _reduce(rnnt_loss_grid(lp_b, lp_l, t_len, u_len), reduction)


def fused_grid_logprobs(enc: torch.Tensor, dec: torch.Tensor, jp,
                        labels: torch.Tensor, blank: int = 0,
                        chunk_size: int = 32, remat: bool = True,
                        activation: str = "tanh",
                        compute_dtype: torch.dtype = torch.float32
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blank/label log-prob grids straight from encoder / label-encoder
    states, T-chunk by T-chunk; with ``remat`` each chunk is recomputed in
    the backward (``torch.utils.checkpoint``) instead of keeping its joint
    activations.  ``activation``: the joint's (``tanh``, or ``relu`` for an
    espnet joint so configured).

    ``compute_dtype`` bf16 reproduces JAX's type promotion with explicit
    casts (torch refuses a mixed-dtype product): the two input products are
    bf16, and the float32 ``b1`` and decoder half promote the sum to
    float32, so the activation and the output product run in float32, the
    latter over bf16-rounded ``w_out`` (cast inside each chunk, as JAX casts
    it in its chunk function)."""
    act = ACTIVATIONS[activation]
    cd = compute_dtype
    w_enc, w_dec, b1, w_out, b_out = jp
    b, t, _ = enc.shape
    u1 = dec.shape[1]
    labels_pad = _pad_labels(labels, u1, blank)
    dec_proj = to_compute(dec, cd) @ to_compute(w_dec, cd) + b1     # (B, U1, inner)

    def chunk_fn(enc_chunk, dec_proj, w_enc, w_out, b_out):
        h = act((to_compute(enc_chunk, cd) @ to_compute(w_enc, cd))[:, :, None, :]
                + dec_proj[:, None, :, :])
        logits = h @ widen(to_compute(w_out, cd)) + b_out             # (B, C, U1, V)
        lse = torch.logsumexp(logits, dim=-1)
        idx = labels_pad[:, None, :, None].expand(-1, enc_chunk.shape[1], -1, -1)
        return (logits[..., blank] - lse,
                torch.gather(logits, -1, idx)[..., 0] - lse)

    lp_b, lp_l = [], []
    for start in range(0, t, chunk_size):
        args = (enc[:, start:start + chunk_size], dec_proj, w_enc, w_out, b_out)
        pb, pl = (checkpoint(chunk_fn, *args, use_reentrant=False) if remat
                  else chunk_fn(*args))
        lp_b.append(pb)
        lp_l.append(pl)
    return torch.cat(lp_b, dim=1), torch.cat(lp_l, dim=1)


def rnnt_loss_fused(enc: torch.Tensor, dec: torch.Tensor, jp,
                    labels: torch.Tensor, t_len, u_len, blank: int = 0,
                    chunk_size: int = 32, reduction: str = "mean",
                    remat: bool = True, activation: str = "tanh",
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """End-to-end training loss from encoder/label-encoder states: the joint
    fused into the loss (no (B,T,U,V) tensor) and the lattice on the grids
    (float32 grids under any ``compute_dtype``)."""
    lp_b, lp_l = fused_grid_logprobs(enc, dec, jp, labels, blank, chunk_size,
                                     remat, activation, compute_dtype)
    return _reduce(rnnt_loss_grid(lp_b, lp_l, t_len, u_len), reduction)
