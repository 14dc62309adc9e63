"""Transformer-XL relative-position attention (port of ``models/attention.py``).

Parity surface (reference ``tt/transformer.py``):

* ``RelLearnableMultiHeadAttn`` (:102-177): fused bias-free QKV projection,
  score = AC + rel_shift(B + D) with learnable per-layer tables
  ``r_emb[k_len,h,d]`` / ``r_w_bias[h,d]`` / ``r_bias[k_len,h]``, additive
  masking, post-LN residual.
* ``_rel_shift`` (:82-95): the pad-one-column-and-reshape trick, including
  its cross-row wrap for ``j > i`` (part of the trained function).
* ``PositionwiseFF`` (:36-58): ONE LayerNorm applied twice (pre-activation
  and on the residual sum).

Module and parameter names follow the upstream torch model, so a layer's
``state_dict`` keys are the reference's
(``MultiHeadAttention.dec_attn.qkv_net.weight``, ...).

Layout: batch-major ``(B, T, D)``; scores ``(B, H, q, k)``.  The attention
has three branches, as in the JAX module: the dense einsum path (any mask),
the banded kernel (``band=(left, right)``) and the full-context flash
kernel (``flash=True`` with no mask); see ``ops/cuda/``.

``compute_dtype=torch.bfloat16`` (``--bf16``) computes over float32
parameters with the JAX module's rounding points, by explicit casts
(``ops/precision.py``): each projection is a bf16 product followed by a
separate bf16 bias add, the scores and the einsums run in bf16, the softmax
in float32 cast back, and the residual stream and the LayerNorms stay
float32.  The banded kernel takes float32 (JAX casts its operands up); the
flash kernels take bf16 in their bf16 forms, which round where JAX's
Pallas kernels round (``ops/cuda/flash_rel_attention.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from transformer_transducer_tpu_torch.ops.precision import (
    NEG_INF, dense, neg_inf, scalar, to_compute, widen)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift on the trailing two dims ``(..., q, k)``.

    Reproduces the reference pad/reshape trick exactly (``tt/transformer.py:
    82-95``), including the cross-row wrap for ``j > i``.
    """
    *lead, q, k = x.shape
    x_padded = nn.functional.pad(x, (1, 0))          # (..., q, k+1)
    x_padded = x_padded.reshape(*lead, k + 1, q)     # flat-order reinterpret
    return x_padded[..., 1:, :].reshape(*lead, q, k)


def slice_pos_table(table: torch.Tensor, klen: int) -> torch.Tensor:
    """Take the last ``klen`` rows; if ``klen`` exceeds the table, front-pad
    by repeating row 0 (reference ``tt/transformer.py:128-135``)."""
    k_len = table.shape[0]
    if klen > k_len:
        pad = table[0:1].expand((klen - k_len,) + tuple(table.shape[1:]))
        return torch.cat([pad, table], dim=0)
    return table[k_len - klen:]


def rel_attention_scores(q: torch.Tensor, k: torch.Tensor, r_emb: torch.Tensor,
                         r_w_bias: torch.Tensor, r_bias: torch.Tensor) -> torch.Tensor:
    """The scaled scores (B, H, T, T) of the dense branch, unmasked:
    ``(AC + rel_shift(B + D)) / sqrt(Dh)``."""
    dh = q.shape[-1]
    ac = torch.einsum("bind,bjnd->bnij", q + r_w_bias, k)
    b_ = torch.einsum("bind,jnd->bnij", q, r_emb)
    d_ = r_bias.t()[None, :, None, :]
    bd = rel_shift(b_ + d_)
    return (ac + bd) * scalar(1.0 / dh ** 0.5, bd.dtype)


def rel_attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        r_emb: torch.Tensor, r_w_bias: torch.Tensor,
                        r_bias: torch.Tensor,
                        attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense branch: einsum + ``rel_shift`` + mask + softmax.

    q, k, v: (B, T, H, Dh); tables sliced to T rows; ``attn_mask`` (T, T) or
    (B, T, T) bool, True == masked.  Returns (B, T, H, Dh) (pre
    out-projection).  It is also the plain version of both attention kernels.
    In the inputs' dtype; the softmax runs in float32 and is cast back.
    """
    score = rel_attention_scores(q, k, r_emb, r_w_bias, r_bias)
    if attn_mask is not None:
        mask = attn_mask[None, None] if attn_mask.dim() == 2 else attn_mask[:, None]
        score = score.masked_fill(mask, neg_inf(score.dtype))
    prob = torch.softmax(widen(score), dim=-1).to(score.dtype)
    return torch.einsum("bnij,bjnd->bind", prob, v)


class RelLearnableSelfAttention(nn.Module):
    """Multi-head self-attention with learnable relative-position tables
    (the tables are owned by :class:`TransformerXLLayer`)."""

    def __init__(self, n_head: int, d_model: int, d_head: int,
                 dropout: float = 0.0, flash: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_head, self.d_head, self.flash = n_head, d_head, flash
        self.compute_dtype = compute_dtype
        self.qkv_net = nn.Linear(d_model, 3 * n_head * d_head, bias=False)
        self.o_net = nn.Linear(n_head * d_head, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, r_emb: torch.Tensor,
                r_w_bias: torch.Tensor, r_bias: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                band: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        b, t, _ = x.shape
        h, dh = self.n_head, self.d_head
        cd = self.compute_dtype
        # q, k, v stay strided views of the fused projection (row stride
        # 3*H*Dh); the kernels read them in place
        q, k, v = dense(self.qkv_net, x, cd).view(b, t, 3, h, dh).unbind(2)
        # the tables in the compute dtype (bf16-rounded under bf16, as JAX's
        # casts round them); r_w_bias is cast where each branch uses it
        r_emb = to_compute(slice_pos_table(r_emb, t), cd)
        r_bias = to_compute(slice_pos_table(r_bias, t), cd)

        if band is None and attn_mask is None and self.flash:
            # under bf16 every operand bf16, r_w_bias too (JAX's
            # r_w_bias.astype(cd)): the kernels' bf16 forms
            from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
                flash_rel_attention)
            vec = flash_rel_attention(q, k, v, r_emb, to_compute(r_w_bias, cd), r_bias)
        elif band is not None:
            # float32 operands, as JAX casts them up before its banded kernel
            # (under float32 the strided views go in as they are)
            from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
                banded_attention)
            vec = banded_attention(widen(q), widen(k), widen(v), widen(r_emb),
                                   r_w_bias, widen(r_bias), int(band[0]), int(band[1]))
        else:
            vec = rel_attention_dense(q, k, v, r_emb, to_compute(r_w_bias, cd), r_bias,
                                      attn_mask)

        out = self.drop(dense(self.o_net, vec.reshape(b, t, h * dh), cd))
        return self.layer_norm(x + out)


class PositionwiseFF(nn.Module):
    """FFN with a SHARED LayerNorm applied pre-activation and post-residual
    (``CoreNet`` indices follow the reference: Linear, ReLU, Dropout,
    Linear, Dropout)."""

    def __init__(self, d_model: int, d_inner: int, dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.CoreNet = nn.Sequential(
            nn.Linear(d_model, d_inner), nn.ReLU(), nn.Dropout(dropout),
            nn.Linear(d_inner, d_model), nn.Dropout(dropout))
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``compute_dtype`` overrides the module's (the label cache runs
        float32)."""
        cd = compute_dtype or self.compute_dtype
        fc1, relu, drop1, fc2, drop2 = self.CoreNet
        h = drop2(dense(fc2, drop1(relu(dense(fc1, self.layer_norm(x), cd))), cd))
        return self.layer_norm(x + widen(h))


class RelLearnableDecoderLayer(nn.Module):
    """Attention -> FFN (reference ``RelLearnableDecoderLayer``,
    ``tt/transformer.py:181-197``)."""

    def __init__(self, n_head: int, d_model: int, d_head: int, d_inner: int,
                 dropout: float = 0.0, flash: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dec_attn = RelLearnableSelfAttention(n_head, d_model, d_head,
                                                  dropout, flash, compute_dtype)
        self.pos_ff = PositionwiseFF(d_model, d_inner, dropout, compute_dtype)


class TransformerXLLayer(nn.Module):
    """One encoder/label-encoder layer: rel-attention -> FFN -> dropout,
    owning its ``k_len``-row position tables (``tt/encoder.py:7-29``)."""

    def __init__(self, k_len: int, n_head: int, d_model: int, d_head: int,
                 d_inner: int, dropout: float = 0.0, flash: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.r_emb = nn.Parameter(torch.randn(k_len, n_head, d_head))
        self.r_w_bias = nn.Parameter(torch.randn(n_head, d_head))
        self.r_bias = nn.Parameter(torch.randn(k_len, n_head))
        self.MultiHeadAttention = RelLearnableDecoderLayer(
            n_head, d_model, d_head, d_inner, dropout, flash, compute_dtype)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                band: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        layer = self.MultiHeadAttention
        x = layer.dec_attn(x, self.r_emb, self.r_w_bias, self.r_bias,
                           attn_mask, band)
        return self.drop(layer.pos_ff(x))
