"""The plain reference of the Transformer-Transducer, in float32 PyTorch.

Written from the published equations (Transformer-Transducer,
arXiv:2002.02562; the reference repository's ``tt/transformer.py``,
``tt/encoder.py``, ``tt/decoder.py`` and ``tt/model.py``), as functions of
a dict of weights keyed by the upstream state-dict names
(``benchmark/weights.py``).  No kernel, cache or chunking: each attention
builds its whole score matrix.

* Relative-position attention: ``score = (AC + rel_shift(B + D)) /
  sqrt(d_head)`` with ``AC = (q + u) k^T``, ``B = q r^T`` and ``D`` the
  per-key bias, the tables' last ``T`` rows (front-padded with row 0 when
  ``T`` is longer than the table), ``rel_shift`` the pad-one-column
  reshape including its wrap above the diagonal; masked scores are
  ``-1e30``; the output projection, dropout, residual and LayerNorm
  (post-LN).
* Feed-forward: one LayerNorm applied before the first product and again
  to the residual sum; ReLU; dropout after each product.
* A layer: attention, feed-forward, dropout.
* Audio encoder: the stacked features are the first layer's input (no
  input projection), under the streaming band mask ``[i - left, i +
  right]`` or with no mask.  Label encoder: token 0 embeds to zero, the
  blank-prefixed history under the causal mask.
* Joint: ``W2 tanh(W1 [enc; dec] + b1) + b2``.

``dropout`` is a callable ``(x) -> x`` that each dropout site calls in the
model's order (attention output, first and second feed-forward product,
layer output; the audio encoder's layers, then the label encoder's), or
None in evaluation.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

NEG = -1e30
Weights = Dict[str, torch.Tensor]
Dropout = Optional[Callable[[torch.Tensor], torch.Tensor]]


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL's shift of ``(..., q, k)`` scores: pad one zero column
    in front, read the buffer as ``(k + 1, q)``, drop its first row."""
    *lead, q, k = x.shape
    padded = torch.nn.functional.pad(x, (1, 0)).reshape(*lead, k + 1, q)
    return padded[..., 1:, :].reshape(*lead, q, k)


def table_rows(table: torch.Tensor, t: int) -> torch.Tensor:
    """The last ``t`` rows of a position table, row 0 repeated in front
    where ``t`` exceeds it."""
    k_len = table.shape[0]
    if t > k_len:
        return torch.cat([table[:1].expand(t - k_len, *table.shape[1:]), table])
    return table[k_len - t:]


def band_mask(t: int, left: int, right: int, device) -> torch.Tensor:
    """True outside ``[i - left, i + right]``."""
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    return (j - i > right) | (i - j > left)


def causal_mask(t: int, device) -> torch.Tensor:
    """True above the diagonal."""
    return torch.ones((t, t), dtype=torch.bool, device=device).triu(1)


def layer_norm(x: torch.Tensor, w: Weights, name: str) -> torch.Tensor:
    return torch.nn.functional.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                                          w[name + ".bias"], 1e-5)


def attention(x: torch.Tensor, w: Weights, p: str, h: int, dh: int,
              mask: Optional[torch.Tensor], dropout: Dropout) -> torch.Tensor:
    b, t, _ = x.shape
    a = p + "MultiHeadAttention.dec_attn."
    q, k, v = (x @ w[a + "qkv_net.weight"].t()).view(b, t, 3, h, dh).unbind(2)
    r_emb = table_rows(w[p + "r_emb"], t)
    r_bias = table_rows(w[p + "r_bias"], t)
    ac = torch.einsum("bind,bjnd->bnij", q + w[p + "r_w_bias"], k)
    bd = rel_shift(torch.einsum("bind,jnd->bnij", q, r_emb) + r_bias.t()[None, :, None, :])
    score = (ac + bd) / dh ** 0.5
    if mask is not None:
        score = score.masked_fill(mask, NEG)
    vec = torch.einsum("bnij,bjnd->bind", torch.softmax(score, -1), v)
    out = vec.reshape(b, t, h * dh) @ w[a + "o_net.weight"].t()
    if dropout is not None:
        out = dropout(out)
    return layer_norm(x + out, w, a + "layer_norm")


def feed_forward(x: torch.Tensor, w: Weights, p: str, dropout: Dropout) -> torch.Tensor:
    f = p + "MultiHeadAttention.pos_ff."
    hid = torch.relu(layer_norm(x, w, f + "layer_norm") @ w[f + "CoreNet.0.weight"].t()
                     + w[f + "CoreNet.0.bias"])
    if dropout is not None:
        hid = dropout(hid)
    out = hid @ w[f + "CoreNet.3.weight"].t() + w[f + "CoreNet.3.bias"]
    if dropout is not None:
        out = dropout(out)
    return layer_norm(x + out, w, f + "layer_norm")


def stack(x: torch.Tensor, w: Weights, prefix: str, n_layer: int, h: int, dh: int,
          mask: Optional[torch.Tensor], dropout: Dropout) -> torch.Tensor:
    for i in range(n_layer):
        p = f"{prefix}.layers.{i}."
        x = feed_forward(attention(x, w, p, h, dh, mask, dropout), w, p, dropout)
        if dropout is not None:
            x = dropout(x)
    return x


def encode_audio(features: torch.Tensor, w: Weights, enc: Dict,
                 band: Optional[Tuple[int, int]], dropout: Dropout = None) -> torch.Tensor:
    """(B, T, D) features -> (B, T, D) encoder states; ``band=(left,
    right)`` or None (full context, padded frames included)."""
    mask = None if band is None else band_mask(features.shape[1], *band, features.device)
    return stack(features, w, "encoder", enc["n_layer"], enc["n_head"], enc["d_head"],
                 mask, dropout)


def encode_labels(history: torch.Tensor, w: Weights, dec: Dict,
                  dropout: Dropout = None) -> torch.Tensor:
    """(B, U) token histories (blank-prefixed) -> (B, U, D) label states
    under the causal mask; token 0 embeds to zero."""
    x = w["decoder.dec_embedding.weight"][history] * (history != 0)[..., None]
    mask = causal_mask(history.shape[1], history.device)
    return stack(x, w, "decoder", dec["n_layer"], dec["n_head"], dec["d_head"], mask, dropout)


def joint_logits(enc: torch.Tensor, dec: torch.Tensor, w: Weights) -> torch.Tensor:
    """(..., T, 1, D) and (..., 1, U, D) (or any broadcastable pair) ->
    (..., T, U, V) logits."""
    w1 = w["joint.forward_layer.weight"]
    d_enc = enc.shape[-1]
    hid = torch.tanh(enc @ w1[:, :d_enc].t() + dec @ w1[:, d_enc:].t()
                     + w["joint.forward_layer.bias"])
    return hid @ w["joint.project_layer.weight"].t() + w["joint.project_layer.bias"]
