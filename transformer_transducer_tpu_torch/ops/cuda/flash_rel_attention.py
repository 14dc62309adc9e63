"""Full-context rel-position attention forward: CUDA kernel + plain version.

Replaces the TPU kernel ``ops/pallas/flash_rel_attention.py::
flash_rel_attention`` forward (``_fwd_impl``, ``_fwd_kernel``): unmasked
Transformer-XL attention with learnable tables, computed per query tile
with an online softmax so no (B, H, T, T) tensor reaches device memory.
The kernel is ``ttx_flash_rel_attention_fwd`` in ``csrc/rel_attention.cu``,
which documents the score rule and bounds.

Dispatch: a CPU tensor takes :func:`flash_rel_attention_plain`; a CUDA
tensor launches the kernel or raises.  ``flash_rel_attention.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from transformer_transducer_tpu_torch.models.attention import rel_attention_dense
from transformer_transducer_tpu_torch.ops.cuda import build
from transformer_transducer_tpu_torch.ops.cuda.common import (
    check_inputs, kernel_args)


def flash_rel_attention_plain(q, k, v, r_emb, r_w_bias, r_bias) -> torch.Tensor:
    """The dense branch with no mask."""
    return rel_attention_dense(q, k, v, r_emb, r_w_bias, r_bias)


def flash_rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        r_emb: torch.Tensor, r_w_bias: torch.Tensor,
                        r_bias: torch.Tensor) -> torch.Tensor:
    """Full-attention rel-position MHA forward (pre out-projection).

    Args: q/k/v (B, T, H, Dh); tables sliced to T rows
    (``models.attention.slice_pos_table``).  Returns (B, T, H, Dh) float32.
    """
    check_inputs(q, k, v, r_emb, r_w_bias, r_bias)
    if q.device.type == "cpu":
        return flash_rel_attention_plain(q, k, v, r_emb, r_w_bias, r_bias)
    lib = build.library()
    ptrs = kernel_args(q, k, v, r_emb, r_w_bias, r_bias, lib.ttx_head_dim())
    b, t, h, dh = q.shape
    out = torch.empty((b, t, h, dh), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(lib.ttx_flash_rel_attention_fwd(*ptrs, out.data_ptr(), b, t, h,
                                                stream),
                "ttx_flash_rel_attention_fwd")
    flash_rel_attention.launches += 1
    return out


flash_rel_attention.launches = 0
