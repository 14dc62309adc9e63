"""KV-cached incremental label encoder, native family (port of
``decoding/label_cache.py``).

Under the causal label mask, position u's output depends only on tokens
<= u, and the rel-position scores depend only on the distance u - j, so
per-layer K/V caches give the full re-encode's result with O(cap) work per
emission.  Exact while the history fits the buffer (offline greedy).

Functions over a :class:`~models.transducer.LabelEncoder`'s weights,
mirroring ``models.attention``; equality-tested against
``Transducer.predict`` under ``look_ahead_mask``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from transformer_transducer_tpu_torch.models.attention import NEG_INF


def init_cache(decoder, batch: int, cap: int) -> Dict:
    """Empty per-layer K/V caches + per-row position counter."""
    layer = decoder.layers[0]
    _, n_head = layer.r_bias.shape
    d_head = layer.r_emb.shape[-1]
    device = layer.r_emb.device
    zeros = lambda: torch.zeros((batch, cap, n_head, d_head), device=device)
    return {"k": [zeros() for _ in decoder.layers],
            "v": [zeros() for _ in decoder.layers],
            "idx": torch.zeros((batch,), dtype=torch.long, device=device)}


def _rel_rows(table: torch.Tensor, idx: torch.Tensor, cap: int) -> torch.Tensor:
    """Table rows for distances d = idx - j, j = 0..cap-1, as (B, cap, ...):
    row(j) = k_len-1-(idx-j), clipped so that distances past the table read
    row 0 (the front-pad rule, reference ``tt/transformer.py:128-135``)."""
    k_len = table.shape[0]
    j = torch.arange(cap, device=idx.device)
    rows = (k_len - 1 - (idx[:, None] - j[None, :])).clamp(0, k_len - 1)
    return table[rows]


def step(decoder, tokens: torch.Tensor, cache: Dict,
         update_mask: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Append ``tokens`` (B,) to the cached history and return the label
    encoder's output at the new position, with the new cache.

    ``update_mask`` (B,) bool: rows whose cache advances.  Rows with
    ``update_mask == False`` get an unspecified output (callers mask it).
    """
    b = tokens.shape[0]
    cap = cache["k"][0].shape[1]
    idx = cache["idx"]
    x = decoder.embed(tokens)
    new_cache = {"k": [], "v": [], "idx": idx + update_mask.long()}

    pos_j = torch.arange(cap, device=tokens.device)[None, :]
    attend = pos_j <= idx[:, None]                          # causal, (B, cap)
    # writes position idx of the rows that advance (the slot is still zero)
    write = ((pos_j == idx[:, None]) & update_mask[:, None]).to(x.dtype)

    for li, layer in enumerate(decoder.layers):
        attn = layer.MultiHeadAttention.dec_attn
        h, dh = layer.r_w_bias.shape
        q, k_new, v_new = attn.qkv_net(x).view(b, 3, h, dh).unbind(1)
        k_cache = cache["k"][li] + write[:, :, None, None] * k_new[:, None]
        v_cache = cache["v"][li] + write[:, :, None, None] * v_new[:, None]
        new_cache["k"].append(k_cache)
        new_cache["v"].append(v_cache)

        ac = torch.einsum("bhd,bjhd->bhj", q + layer.r_w_bias, k_cache)
        re_rows = _rel_rows(layer.r_emb, idx, cap)          # (B, cap, H, Dh)
        rb_rows = _rel_rows(layer.r_bias, idx, cap)         # (B, cap, H)
        bd = torch.einsum("bhd,bjhd->bhj", q, re_rows) + rb_rows.transpose(1, 2)
        score = (ac + bd) / dh ** 0.5
        score = score.masked_fill(~attend[:, None, :], NEG_INF)
        prob = torch.softmax(score, dim=-1)
        vec = torch.einsum("bhj,bjhd->bhd", prob, v_cache).reshape(b, h * dh)
        x = attn.layer_norm(x + attn.o_net(vec))
        # float32 whatever the model's compute dtype (JAX's cache reads the
        # weights and ignores it)
        x = layer.MultiHeadAttention.pos_ff(x, torch.float32)

    return x, new_cache
