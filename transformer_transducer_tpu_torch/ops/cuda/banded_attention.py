"""Banded rel-position attention, forward and backward: CUDA kernels + plain
version.

Replaces the TPU kernels of ``ops/pallas/banded_attention.py::
banded_attention``: the forward (``_fwd_impl``, ``_band_kernel``) and the
backward (``_bwd_impl``, ``_band_bwd_kernel``).  The streaming encoder
attends within ``[i - left, i + right]`` (reference ``tt/utils.py:242-251``);
the kernels (``csrc/rel_attention.cu``, ``ttx_banded_attention_fwd``;
``csrc/banded_attention_bwd.cu``, ``ttx_banded_attention_bwd``; head widths
32 and 64) work only inside the band, with the score rule and bounds
documented in the sources.  The backward writes every gradient once, with
no atomics, so its results do not change from run to run.

Dispatch: a CPU tensor takes :func:`banded_attention_plain` (its gradients
by autograd); a CUDA tensor runs the kernels behind a
``torch.autograd.Function`` or raises.  ``banded_attention.launches``
counts forward launches, ``banded_attention_backward.launches`` backward
launches (each runs two kernels: the cells, then the table sums).
"""

from __future__ import annotations

import torch

from transformer_transducer_tpu_torch.models.attention import rel_attention_dense
from transformer_transducer_tpu_torch.ops.cuda import build
from transformer_transducer_tpu_torch.ops.cuda.common import (
    HALO, check_inputs, launch_backward, launch_forward)
from transformer_transducer_tpu_torch.ops.masks import context_mask


def banded_attention_plain(q, k, v, r_emb, r_w_bias, r_bias, left: int,
                           right: int) -> torch.Tensor:
    """The dense branch under ``context_mask(T, left, right)``."""
    mask = context_mask(q.shape[1], left, right, device=q.device)
    return rel_attention_dense(q, k, v, r_emb, r_w_bias, r_bias, mask)


def banded_attention_backward(q, k, v, r_emb, r_w_bias, r_bias, out, lse,
                              grad, left: int, right: int):
    """The backward kernel: gradients of q, k, v, r_emb, r_w_bias, r_bias
    (tables as sliced to T rows) over the band."""
    scratch = build.library().ttx_banded_attention_bwd_scratch(*q.shape, left, right)
    grads, launched = launch_backward(
        "ttx_banded_attention_bwd",
        (q, k, v, r_emb, r_w_bias, r_bias, out, lse), grad, (left, right), scratch)
    banded_attention_backward.launches += int(launched)
    return grads


banded_attention_backward.launches = 0


class _BandedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, r_emb, r_w_bias, r_bias, left, right):
        inputs = (q, k, v, r_emb, r_w_bias, r_bias)
        out, lse, launched = launch_forward(
            "ttx_banded_attention_fwd", inputs, (left, right),
            with_lse=any(ctx.needs_input_grad))
        banded_attention.launches += int(launched)
        ctx.band = (left, right)
        ctx.save_for_backward(*inputs, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        grads = banded_attention_backward(*ctx.saved_tensors, grad, *ctx.band)
        return (*grads, None, None)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     r_emb: torch.Tensor, r_w_bias: torch.Tensor,
                     r_bias: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Banded rel-attention, differentiable.

    Args:
      q, k, v: (B, T, H, Dh) post-projection heads (strided views of the
        fused projection are taken in place).
      r_emb: (T, H, Dh), r_w_bias: (H, Dh), r_bias: (T, H) — tables already
        sliced/front-padded to T rows (``models.attention.slice_pos_table``).
      left, right: band widths, 0 <= left, right <= 64.
    Returns: (B, T, H, Dh) float32 attention output (pre out-projection).
    """
    check_inputs(q, k, v, r_emb, r_w_bias, r_bias)
    if not (0 <= left <= HALO and 0 <= right <= HALO):
        raise ValueError(f"band ({left}, {right}) outside [0, {HALO}]")
    if q.device.type == "cpu":
        return banded_attention_plain(q, k, v, r_emb, r_w_bias, r_bias,
                                      left, right)
    return _BandedAttention.apply(q, k, v, r_emb, r_w_bias, r_bias,
                                  int(left), int(right))


banded_attention.launches = 0
