"""Incremental (cached) streaming encoder for the native family (port of
``streaming/incremental.py``).

The window session re-encodes a ``n_layer*left`` history halo and a
``n_layer*right`` future halo around every ~1 s of new frames (reference
``audio/streamRec_unlimit_dynamic_window.py:61-63,160-183``): at the
18-layer flagship 180 + ~36 + 36 frames of 18-layer encode per ~36 new
ones.  Here each layer caches the last ``left + right`` rows of its *input*
stream, and one step advances every layer by the chunk's new rows: work in
the new rows, not in the halo.

The banded rel-attention scores are evaluated in closed form, with the
rel-shift wrap of the reference (``tt/transformer.py:82-95,128-135``):

* ``j - i = dj in [-left, 0]``: ``q_i . re[K-1+dj] + rb[K-1+dj]``, the LAST
  table rows, the same at any window length;
* ``dj = +1``: 0 (the rel-shift's zero-pad column);
* ``dj in [2, right]``: ``q_{i+1} . re_w[dj-2] + rb_w[dj-2]`` with
  ``re_w[m] = table[max(0, k_len - W + m)]``, the wrap row pinned to the
  session's fixed ``window_len`` W, as the padded window pins it
  (``streaming/session.py::StreamingConfig.window_len``).

Each layer's output frontier lags its input frontier by ``right`` rows, so
the encoder output lags the features by ``n_layer*right``, the window
path's latency.  At the stream's end ``n_layer*right`` zero rows flush the
layers; ``key_limit`` reproduces the canonical final window's clip (keys at
positions at or past the window's last padded row do not exist there).

The steps are plain tensor code (no kernel): a chunk is at most
``chunk_len`` rows, and its products are small.  Each step runs on the
rows it was given, with no padding to a fixed chunk shape: the rows past
``n_new`` of the JAX program are masked out of every key and dropped from
every output, so leaving them out changes no value.  Only the band's
cells are scored (windows of the keys, ``unfold``), where the JAX step
scores every key and masks those outside the band: the masked cells add
exact zeros to the softmax, so the values agree to float32 rounding.

The layer norms are the port's ``nn.LayerNorm`` modules (two-pass
variance), the formula of the port's window path; the JAX step uses
flax's fast variance, ``max(0, E[x^2] - mu^2)``, which agrees with it to
float32 rounding.  The espnet family (its shift-invariant step) and int8
are ported in later slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from transformer_transducer_tpu_torch.models.attention import NEG_INF

_BIG = 2 ** 30  # "no key limit" sentinel (positions are small ints)


@torch.no_grad()
def prepare_layers(model, left: int, right: int, window_len: int) -> List[Dict]:
    """Per encoder layer: the module and the table rows its closed form
    reads, sliced once (they are weights): the main band's LAST ``left+1``
    rows and the ``right-1`` wrap rows ``max(0, k_len - window_len + m)``,
    pinned to the window (front-pad rule when ``window_len > k_len``), each
    as (H, Dh, rows) for the products and (H, rows) for the biases.  A
    model of the espnet family raises (a later slice)."""
    from transformer_transducer_tpu_torch.models.transducer import Transducer
    if not isinstance(model, Transducer):
        raise NotImplementedError(
            "the incremental encoder of the espnet family is ported in a "
            "later slice of the PyTorch port")
    out = []
    for layer in model.encoder.layers:
        re, rb = layer.r_emb, layer.r_bias
        k_len = re.shape[0]
        # the main band takes the LAST left+1 rows directly; a table shorter
        # than the left context would need the front-pad rule
        # (models.attention.slice_pos_table) instead
        if k_len <= left:
            raise ValueError(f"encoder k_len {k_len} must exceed the left "
                             f"context {left} for the incremental closed form")
        wrap = (torch.arange(max(right - 1, 0), device=re.device)
                + (k_len - window_len)).clamp(min=0)
        out.append({"layer": layer,
                    "re_main": re[k_len - 1 - left:].permute(1, 2, 0),
                    "rb_main": rb[k_len - 1 - left:].t()[:, None],
                    "re_wrap": re[wrap].permute(1, 2, 0),
                    "rb_wrap": rb[wrap].t()[:, None]})
    return out


def init_cache(n_layer: int, left: int, right: int, d_model: int,
               device=None) -> Dict:
    """Fresh stream state: per-layer input ring (last ``left+right`` rows)
    plus the feature-frontier count ``n_in`` (a host int)."""
    return {"bufs": torch.zeros((n_layer, left + right, d_model),
                                dtype=torch.float32, device=device),
            "n_in": 0}


def _layer_step(p: Dict, buf: torch.Tensor, x_new: torch.Tensor, pos0: int,
                key_limit: int, band_keys: torch.Tensor, *, left: int,
                right: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One encoder layer, one chunk.

    Args:
      p: the layer as ``prepare_layers`` gives it.
      buf: (L+R, D) cached input rows (positions ``[pos0-L-R, pos0)``).
      x_new: (C, D) new input rows (positions ``[pos0, pos0+C)``).
      pos0: this layer's input frontier before the step.
      key_limit: keys at positions >= this do not exist (canonical
          final-window clipping); ``_BIG`` during streaming.
      band_keys: (C, L+R+1), ``i + m``: the row of query i's m-th band key
          (offset ``m - L``) in ``cat([buf, x_new])``.

    Returns ``(new_buf, out)``: out (C, D), the layer outputs for positions
    ``[pos0 - R, pos0 + C - R)``.

    Query i (row ``L + i``) attends to the rows ``i .. i + L + R``, the
    band's offsets ``-L .. R``, taken as views of the keys and values, so
    only band cells are scored.  The BD term of offset ``m - L`` is
    ``q_i . re_main[m]`` for ``m <= L``, 0 at ``m = L + 1`` and
    ``q_{i+1} . re_wrap[m - L - 2]`` past it.
    """
    L, R = left, right
    layer = p["layer"]
    attn = layer.MultiHeadAttention.dec_attn
    H, dh = attn.n_head, attn.d_head
    C = x_new.shape[0]
    K, W = L + R + C, L + R + 1
    concat = torch.cat([buf, x_new], dim=0)                  # (K, D)
    # rows [lo, hi) hold positions in [0, key_limit); zero the others (they
    # are masked out of every key, but a NaN from an all-masked row upstream
    # must not ride the V product, 0 * NaN)
    lo = min(K, max(0, L + R - pos0))
    hi = max(lo, min(K, key_limit - pos0 + L + R))
    if lo > 0 or hi < K:
        concat = torch.nn.functional.pad(concat[lo:hi], (0, 0, lo, K - hi))

    q, k, v = attn.qkv_net(concat).view(K, 3, H, dh).unbind(1)
    qm = q[L:L + C]                                          # (C, H, dh)
    ac = torch.matmul((qm + layer.r_w_bias)[:, :, None], k.unfold(0, W, 1))[:, :, 0]
    parts = [torch.matmul(qm.transpose(0, 1), p["re_main"]) + p["rb_main"]]
    if R >= 1:                                               # the zero column
        parts.append(qm.new_zeros((H, C, 1)))
    if R >= 2:                                               # the wrap, row i+1
        parts.append(torch.matmul(q[L + 1:L + C + 1].transpose(0, 1), p["re_wrap"])
                     + p["rb_wrap"])
    score = (ac + torch.cat(parts, dim=-1).transpose(0, 1)) * (1.0 / dh ** 0.5)
    if lo > 0 or hi < K:
        invalid = (band_keys < lo) | (band_keys >= hi)
        score = score.masked_fill(invalid[:, None, :], NEG_INF)
    prob = torch.softmax(score, dim=-1)                      # (C, H, W)
    vec = torch.matmul(prob[:, :, None], v.unfold(0, W, 1).transpose(-1, -2))
    y = attn.layer_norm(concat[L:L + C] + attn.o_net(vec.reshape(C, H * dh)))
    y = layer.MultiHeadAttention.pos_ff(y)
    return concat[C:], y


def incremental_encode_step(layers: List[Dict], cache: Dict, x_new: torch.Tensor,
                            key_limit: Optional[int] = None, *, left: int,
                            right: int) -> Tuple[Dict, torch.Tensor, int]:
    """Advance the whole encoder by one chunk.

    Args:
      layers: ``prepare_layers``'s list.
      cache: ``init_cache`` state.
      x_new: (C, D) new feature rows.
      key_limit: optional position clip for the canonical final window.

    Returns ``(new_cache, out, out_start)``: out (C, D) encoder outputs, row
    j the output for position ``out_start + j`` where ``out_start = n_in -
    n_layer*right`` (rows at negative positions or past the content length
    are flush rows for the caller to skip).
    """
    n_in = cache["n_in"]
    key_limit = _BIG if key_limit is None else int(key_limit)
    C, dev = x_new.shape[0], x_new.device
    band_keys = (torch.arange(C, device=dev)[:, None]
                 + torch.arange(left + right + 1, device=dev)[None])
    x, bufs = x_new, []
    for k, p in enumerate(layers):
        buf, x = _layer_step(p, cache["bufs"][k], x, n_in - k * right, key_limit,
                             band_keys, left=left, right=right)
        bufs.append(buf)
    new_cache = {"bufs": torch.stack(bufs), "n_in": n_in + C}
    return new_cache, x, n_in - len(layers) * right


def make_incremental_encoder(model, cfg):
    """For the sessions: ``(layers, (n_layer, d_model), step)`` where
    ``layers`` is ``prepare_layers``'s list (the wrap pinned to
    ``cfg.window_len``) and ``step(layers, cache, x_new, key_limit) ->
    (cache, out, out_start)`` the native family's cached-encoder step.  The
    espnet family raises ``NotImplementedError`` (a later slice)."""
    layers = prepare_layers(model, cfg.left_context, cfg.right_context, cfg.window_len)
    d_model = layers[0]["layer"].MultiHeadAttention.dec_attn.qkv_net.in_features

    def step(layers, cache, x_new, key_limit):
        return incremental_encode_step(layers, cache, x_new, key_limit,
                                       left=cfg.left_context, right=cfg.right_context)

    return layers, (len(layers), d_model), step


def chunked_encode_key_limit(t: int, left_len: int, right_len: int,
                             step: int, fixed_len: int) -> int:
    """Key capacity of ``streaming.session.chunked_encode``'s FINAL window
    (its start + fixed_len): keys at positions >= this do not exist in the
    canonical program, so the incremental path masks them to match the
    tail frames exactly."""
    pos = 0
    while pos < t:
        end = min(pos + step + right_len, t)
        left_frame = min(left_len, pos)
        start = pos - left_frame
        right_frame = right_len if end < t else 0
        if end == t:
            return start + fixed_len
        pos += (end - start) - left_frame - right_frame
    return t + fixed_len


@torch.no_grad()
def incremental_encode(model, features: np.ndarray, *, left: int, right: int,
                       window_len: int, chunk: int = 40,
                       key_limit: Optional[int] = None) -> np.ndarray:
    """Whole-sequence incremental encode (test and diagnostic harness):
    feeds ``features`` chunk by chunk plus the flush tail on the model's
    device and reassembles the output stream.  Equals
    ``streaming.session.chunked_encode`` at the same pinned ``window_len``,
    by default including the canonical final window's key clip
    (``chunked_encode_key_limit`` at chunked_encode's default ``step``); pass
    ``key_limit`` when comparing with another window geometry."""
    layers = prepare_layers(model, left, right, window_len)
    device = next(model.parameters()).device
    n_layer, d_model = len(layers), features.shape[1]
    cache = init_cache(n_layer, left, right, d_model, device)
    t = features.shape[0]
    lag = n_layer * right
    padded = np.concatenate([features, np.zeros((lag, d_model), np.float32)])
    if key_limit is None:
        key_limit = chunked_encode_key_limit(t, n_layer * left, lag,
                                             max(lag, 1), window_len)
    outs = []
    for p in range(0, padded.shape[0], chunk):
        rows = torch.from_numpy(padded[p:p + chunk]).to(device)
        cache, out, s = incremental_encode_step(layers, cache, rows, key_limit,
                                                left=left, right=right)
        lo, hi = max(0, -s), min(rows.shape[0], t - s)
        if hi > lo:
            outs.append(out[lo:hi])
    return torch.cat(outs).cpu().numpy()
