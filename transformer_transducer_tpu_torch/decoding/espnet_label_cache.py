"""KV-cached incremental label encoder, espnet family (port of
``decoding/espnet_label_cache.py``).

The espnet text encoder runs under a causal band (left ``decoder_left_mask``,
right 0), and its rel-position scores depend only on the distance ``i - j``
(the sinusoidal encodings are rel-indexed), so per-layer K/V caches give the
full re-encode's result: the cached form of the reference's
``forward_one_step`` (``espnet2/asr/encoder/transformer_encoder.py:241-283``).

Functions over an :class:`~models.espnet_variant.EspnetTransformerEncoder`'s
weights, with the native ``decoding/label_cache.py``'s contract,
``step(decoder, tokens, cache, update_mask, left)``.  The cache
holds the reversed sinusoidal distance table (row d encodes distance d),
made once, and its projection through each layer's ``linear_pos``; the
position rows a query reads are gathered by distance from the projected
table.  Both are the same for every row of a batch: the beam's parent
gathers leave them as they are.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from transformer_transducer_tpu_torch.models.espnet_variant import (
    NEG_INF, rel_positional_encoding)


def init_cache(decoder, batch: int, cap: int) -> Dict:
    """Empty per-layer K/V caches, the per-row position counter, the
    distance table ``pos`` (cap, D) and its per-layer projections ``p``
    (cap, H, Dh)."""
    attn = decoder.encoders[0].self_attn
    h, dk = attn.h, attn.d_k
    device = decoder.after_norm.weight.device
    # rel_positional_encoding(L, d) row j encodes rel = L-1-j; rows 0..L-1
    # cover rel = L-1..0: reversed, row d encodes distance d
    pos = torch.from_numpy(np.ascontiguousarray(
        rel_positional_encoding(cap, decoder.output_size)[:cap][::-1])).to(device)
    zeros = lambda: torch.zeros((batch, cap, h, dk), device=device)
    return {"k": [zeros() for _ in decoder.encoders],
            "v": [zeros() for _ in decoder.encoders],
            "idx": torch.zeros((batch,), dtype=torch.long, device=device),
            "pos": pos,
            "p": [layer.self_attn.linear_pos(pos).view(cap, h, dk)
                  for layer in decoder.encoders]}


def step(decoder, tokens: torch.Tensor, cache: Dict, update_mask: torch.Tensor,
         left: int = 2) -> Tuple[torch.Tensor, Dict]:
    """Append ``tokens`` (B,) and return the text encoder's output at the
    new position (after ``after_norm``), with the new cache.

    ``left``: the band; position i attends to j in [i - left, i].  The
    decoder's zero-embedding row (espnet ``padding_idx`` -1 == V - 1, which
    is also sos; the quirk is kept) embeds to zero here too.  Rows with
    ``update_mask == False`` get an unspecified output."""
    b = tokens.shape[0]
    cap = cache["k"][0].shape[1]
    idx = cache["idx"]
    x = decoder.input_transform(tokens)[0] * math.sqrt(decoder.output_size)
    new_cache = {**cache, "k": [], "v": [], "idx": idx + update_mask.long()}

    pos_j = torch.arange(cap, device=tokens.device)[None, :]
    dist = idx[:, None] - pos_j                                  # (B, cap)
    attend = (dist >= 0) & (dist <= left)
    write = ((pos_j == idx[:, None]) & update_mask[:, None]).to(x.dtype)
    rows = dist.clamp(0, cap - 1)                 # clipped reads are masked

    for li, layer in enumerate(decoder.encoders):
        attn = layer.self_attn
        h, dk = attn.h, attn.d_k
        y = layer.norm1(x)
        q = attn.linear_q(y).view(b, h, dk)
        k_cache = cache["k"][li] + write[:, :, None, None] * attn.linear_k(y).view(b, 1, h, dk)
        v_cache = cache["v"][li] + write[:, :, None, None] * attn.linear_v(y).view(b, 1, h, dk)
        new_cache["k"].append(k_cache)
        new_cache["v"].append(v_cache)

        ac = torch.einsum("bhd,bjhd->bhj", q + attn.pos_bias_u, k_cache)
        bd_all = torch.einsum("bhd,mhd->bhm", q + attn.pos_bias_v, cache["p"][li])
        bd = bd_all.gather(2, rows[:, None, :].expand(b, h, cap))
        score = ((ac + bd) / math.sqrt(dk)).masked_fill(~attend[:, None, :], NEG_INF)
        prob = torch.softmax(score, dim=-1)
        vec = torch.einsum("bhj,bjhd->bhd", prob, v_cache).reshape(b, h * dk)
        x = x + attn.linear_out(vec)
        # float32 whatever the model's compute dtype (JAX's cache reads the
        # weights and ignores it)
        x = x + layer.feed_forward(layer.norm2(x), torch.float32)
    return decoder.after_norm(x), new_cache
