"""Banded rel-position attention forward: CUDA kernel + plain version.

Replaces the TPU kernel ``ops/pallas/banded_attention.py::banded_attention``
forward (``_fwd_impl``, ``_band_kernel``).  The streaming encoder attends
within ``[i - left, i + right]`` (reference ``tt/utils.py:242-251``); the
kernel (``csrc/rel_attention.cu``, ``ttx_banded_attention_fwd``) walks only
that key window, with the score rule and bounds documented in the source.

Dispatch: a CPU tensor takes :func:`banded_attention_plain`; a CUDA tensor
launches the kernel or raises.  ``banded_attention.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from transformer_transducer_tpu_torch.models.attention import rel_attention_dense
from transformer_transducer_tpu_torch.ops.cuda import build
from transformer_transducer_tpu_torch.ops.cuda.common import (
    HALO, check_inputs, kernel_args)
from transformer_transducer_tpu_torch.ops.masks import context_mask


def banded_attention_plain(q, k, v, r_emb, r_w_bias, r_bias, left: int,
                           right: int) -> torch.Tensor:
    """The dense branch under ``context_mask(T, left, right)``."""
    mask = context_mask(q.shape[1], left, right, device=q.device)
    return rel_attention_dense(q, k, v, r_emb, r_w_bias, r_bias, mask)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     r_emb: torch.Tensor, r_w_bias: torch.Tensor,
                     r_bias: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Banded rel-attention forward.

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
    lib = build.library()
    ptrs = kernel_args(q, k, v, r_emb, r_w_bias, r_bias, lib.ttx_head_dim())
    b, t, h, dh = q.shape
    out = torch.empty((b, t, h, dh), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(lib.ttx_banded_attention_fwd(*ptrs, out.data_ptr(), b, t, h,
                                             left, right, stream),
                "ttx_banded_attention_fwd")
    banded_attention.launches += 1
    return out


banded_attention.launches = 0
