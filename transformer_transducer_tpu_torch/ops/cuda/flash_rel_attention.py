"""Full-context rel-position attention, forward and backward: CUDA kernels
+ plain version.

Replaces the TPU kernels of ``ops/pallas/flash_rel_attention.py::
flash_rel_attention``: the forward (``_fwd_impl``, ``_fwd_kernel``) and the
backward (``_vjp_bwd``, ``_bwd_kernel``).  Unmasked Transformer-XL attention
with learnable tables, computed per query tile with an online softmax so no
(B, H, T, T) tensor reaches device memory; the backward recomputes the
probabilities from the row log-sum-exp the forward keeps.  The kernels are
``ttx_flash_rel_attention_fwd`` / ``_bwd`` in ``csrc/rel_attention.cu``,
which documents the score rule and bounds.

Dispatch: a CPU tensor takes :func:`flash_rel_attention_plain` (its
gradients by autograd); a CUDA tensor runs the kernels behind a
``torch.autograd.Function`` or raises.  ``flash_rel_attention.launches``
counts forward launches, ``flash_rel_attention_backward.launches`` backward
launches.
"""

from __future__ import annotations

import torch

from transformer_transducer_tpu_torch.models.attention import rel_attention_dense
from transformer_transducer_tpu_torch.ops.cuda.common import (
    check_inputs, launch_backward, launch_forward)


def flash_rel_attention_plain(q, k, v, r_emb, r_w_bias, r_bias) -> torch.Tensor:
    """The dense branch with no mask."""
    return rel_attention_dense(q, k, v, r_emb, r_w_bias, r_bias)


def flash_rel_attention_backward(q, k, v, r_emb, r_w_bias, r_bias, out, lse,
                                 grad):
    """The backward kernel: gradients of q, k, v, r_emb, r_w_bias, r_bias
    (tables as sliced to T rows) from the forward's inputs, output and row
    log-sum-exp."""
    grads, launched = launch_backward(
        "ttx_flash_rel_attention_bwd",
        (q, k, v, r_emb, r_w_bias, r_bias, out, lse), grad, ())
    flash_rel_attention_backward.launches += int(launched)
    return grads


flash_rel_attention_backward.launches = 0


class _FlashRelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, r_emb, r_w_bias, r_bias):
        inputs = (q, k, v, r_emb, r_w_bias, r_bias)
        out, lse, launched = launch_forward(
            "ttx_flash_rel_attention_fwd", inputs, (),
            with_lse=any(ctx.needs_input_grad))
        flash_rel_attention.launches += int(launched)
        ctx.save_for_backward(*inputs, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        return flash_rel_attention_backward(*ctx.saved_tensors, grad)


def flash_rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        r_emb: torch.Tensor, r_w_bias: torch.Tensor,
                        r_bias: torch.Tensor) -> torch.Tensor:
    """Full-attention rel-position MHA (pre out-projection), differentiable.

    Args: q/k/v (B, T, H, Dh); tables sliced to T rows
    (``models.attention.slice_pos_table``).  Returns (B, T, H, Dh) float32.
    """
    check_inputs(q, k, v, r_emb, r_w_bias, r_bias)
    if q.device.type == "cpu":
        return flash_rel_attention_plain(q, k, v, r_emb, r_w_bias, r_bias)
    return _FlashRelAttention.apply(q, k, v, r_emb, r_w_bias, r_bias)


flash_rel_attention.launches = 0
