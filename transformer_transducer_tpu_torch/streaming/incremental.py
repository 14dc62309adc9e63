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

``batched_encode_step`` advances N streams at once (the batched session's
rounds): a chunk of C rows a stream, the first ``n_new[i]`` of stream i
valid, each stream's frontier ``n_in`` and ``key_limit`` tensors, so the
key range of every stream and layer is a mask computed on the device;
stream by stream it is ``incremental_encode_step`` on the valid rows.

The layer norms are the port's ``nn.LayerNorm`` modules (two-pass
variance), the formula of the port's window path; the JAX step uses
flax's fast variance, ``max(0, E[x^2] - mu^2)``, which agrees with it to
float32 rounding.  The projections are the layers' own modules, so an
int8 model (``ops/quant.py::QuantLinear``) runs W8A8 here with per-row
activation scales, as the window path does and as the JAX step's
``_dense`` does.

The espnet family's step (``incremental_encode_step_espnet``, batched as
``batched_encode_step_espnet``) is simpler: its sinusoidal encodings are
shift-invariant, so the band's ``left + right + 1`` position rows
(``espnet_rel_rows``) are the same at any window length, with no wrap row
and nothing pinned.  Its pre-LN layers re-zero masked cells after the
softmax (a query with no live key attends to nothing), the input layer
(None or ``linear``) and the sqrt(d) scale run on the raw feature rows in
the step, flush zeros included, as the padded windows run them, and
``after_norm`` on the rows that emerge.  A conv-subsampling input layer
raises ``ValueError``: its feature and encoder rows differ in rate, which
the window geometry does not follow either.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from transformer_transducer_tpu_torch.models.attention import NEG_INF
from transformer_transducer_tpu_torch.models.espnet_variant import (
    EspnetTransducer, sinusoid_rows)

_BIG = 2 ** 30  # "no key limit" sentinel (positions are small ints)


@torch.no_grad()
def prepare_layers(model, left: int, right: int, window_len: int) -> List[Dict]:
    """Per encoder layer: the module and the table rows its closed form
    reads, sliced once (they are weights): the main band's LAST ``left+1``
    rows and the ``right-1`` wrap rows ``max(0, k_len - window_len + m)``,
    pinned to the window (front-pad rule when ``window_len > k_len``), each
    as (H, Dh, rows) for the products and (H, rows) for the biases.  Native
    family only (the espnet family's is ``prepare_espnet``); another model
    raises ``ValueError``."""
    from transformer_transducer_tpu_torch.models.transducer import Transducer
    if not isinstance(model, Transducer):
        raise ValueError(f"no incremental encoder for a {type(model).__name__}: "
                         "expected a Transducer or an EspnetTransducer")
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


def init_batched_cache(n_streams: int, n_layer: int, left: int, right: int,
                       d_model: int, device=None) -> Dict:
    """Fresh state of ``n_streams`` streams: (N, n_layer, L+R, D) input
    rings and the per-stream feature frontier ``n_in`` (N,), on the device."""
    return {"bufs": torch.zeros((n_streams, n_layer, left + right, d_model),
                                dtype=torch.float32, device=device),
            "n_in": torch.zeros((n_streams,), dtype=torch.long, device=device)}


def _batched_layer_step(p: Dict, buf: torch.Tensor, x_new: torch.Tensor,
                        n_new: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                        band_keys: torch.Tensor, *, left: int,
                        right: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_layer_step`` over N streams at once (the JAX step ``vmap``ped).

    Args:
      buf: (N, L+R, D) cached input rows of each stream.
      x_new: (N, C, D) new input rows; stream i's first ``n_new[i]`` valid.
      n_new: (N,) valid new rows a stream.
      lo, hi: (N,) stream i's rows ``[lo, hi)`` of ``cat([buf, x_new])``
          hold keys: positions in ``[0, key_limit)`` among its first
          ``L + R + n_new`` rows.
      band_keys: (C, L+R+1) as in ``_layer_step``.

    Returns ``(new_buf, out)``: new_buf[i] the rows ``n_new[i] ..
    n_new[i] + L + R`` of stream i's concat, out (N, C, D) whose rows past
    ``n_new[i]`` are flush rows for the caller to skip.
    """
    L, R = left, right
    layer = p["layer"]
    attn = layer.MultiHeadAttention.dec_attn
    H, dh = attn.n_head, attn.d_head
    N, C, D = x_new.shape
    K, W = L + R + C, L + R + 1
    rows = torch.arange(K, device=x_new.device)
    row_ok = (rows >= lo[:, None]) & (rows < hi[:, None])                  # (N, K)
    # invalid rows are zeroed before any product (0 * NaN is NaN)
    concat = torch.where(row_ok[..., None], torch.cat([buf, x_new], dim=1), 0.0)

    q, k, v = attn.qkv_net(concat).view(N, K, 3, H, dh).unbind(2)
    qm = q[:, L:L + C]                                                     # (N, C, H, dh)
    ac = torch.matmul((qm + layer.r_w_bias)[..., None, :], k.unfold(1, W, 1))[..., 0, :]
    parts = [torch.matmul(qm.transpose(1, 2), p["re_main"]) + p["rb_main"]]
    if R >= 1:
        parts.append(qm.new_zeros((N, H, C, 1)))
    if R >= 2:
        parts.append(torch.matmul(q[:, L + 1:L + C + 1].transpose(1, 2), p["re_wrap"])
                     + p["rb_wrap"])
    score = (ac + torch.cat(parts, dim=-1).transpose(1, 2)) * (1.0 / dh ** 0.5)
    invalid = (band_keys < lo[:, None, None]) | (band_keys >= hi[:, None, None])
    score = score.masked_fill(invalid[:, :, None, :], NEG_INF)            # (N, C, H, W)
    prob = torch.softmax(score, dim=-1)
    vec = torch.matmul(prob[..., None, :], v.unfold(1, W, 1).transpose(-1, -2))
    y = attn.layer_norm(concat[:, L:L + C] + attn.o_net(vec.reshape(N, C, H * dh)))
    y = layer.MultiHeadAttention.pos_ff(y)
    keep = (n_new[:, None] + torch.arange(L + R, device=x_new.device))[..., None]
    return concat.gather(1, keep.expand(-1, -1, D)), y


def batched_encode_step(layers: List[Dict], cache: Dict, x_new: torch.Tensor,
                        n_new: torch.Tensor, key_limit: torch.Tensor, *, left: int,
                        right: int) -> Tuple[Dict, torch.Tensor, torch.Tensor]:
    """Advance N streams' encoders by one chunk each.

    Args:
      layers: ``prepare_layers``'s list.
      cache: ``init_batched_cache`` state of the N streams.
      x_new: (N, C, D) new feature rows; stream i's first ``n_new[i]`` valid.
      n_new: (N,) long, valid rows a stream (0: the stream does not move).
      key_limit: (N,) long, stream i's keys at positions >= it do not exist
          (``_BIG`` while streaming).

    Returns ``(new_cache, out, out_start)``: out (N, C, D), row j of stream
    i the output for position ``out_start[i] + j`` for j < ``n_new[i]``,
    ``out_start = n_in - n_layer*right`` (rows at negative positions or past
    the content are flush rows for the caller to skip).  Stream by stream
    this is ``incremental_encode_step`` on the first ``n_new[i]`` rows.
    The key range of each stream and layer is a tensor: no host value is
    read.
    """
    n_in, C = cache["n_in"], x_new.shape[1]
    L, R = left, right
    K, dev = L + R + C, x_new.device
    band_keys = (torch.arange(C, device=dev)[:, None]
                 + torch.arange(L + R + 1, device=dev)[None])
    x, bufs = x_new, []
    for k, p in enumerate(layers):
        pos0 = n_in - k * R                     # each layer's input frontier
        lo = (L + R - pos0).clamp(0, K)
        hi = torch.maximum(lo, torch.minimum(key_limit - pos0, n_new) + (L + R))
        buf, x = _batched_layer_step(p, cache["bufs"][:, k], x, n_new, lo, hi, band_keys,
                                     left=L, right=R)
        bufs.append(buf)
    new_cache = {"bufs": torch.stack(bufs, dim=1), "n_in": n_in + n_new}
    return new_cache, x, n_in - len(layers) * R


# ---------------------------------------------------------------------------
# Espnet family: the shift-invariant band


def espnet_rel_rows(left: int, right: int, d_model: int) -> np.ndarray:
    """Sinusoid rows for ``rel = i - j`` at the band's offsets ``dj = j - i``:
    row ``m = dj + left`` encodes ``rel = left - m``, the only rows of
    ``rel_positional_encoding`` a banded query reads (the same formula, so
    the window and incremental paths project the same vectors)."""
    return sinusoid_rows(left - np.arange(left + right + 1), d_model)


def prepare_espnet(model, left: int, right: int) -> Dict:
    """The espnet encoder and its band's position rows on its device.  A
    conv-subsampling input layer raises ``ValueError`` (as in JAX)."""
    from transformer_transducer_tpu_torch.streaming.session import check_streamable
    check_streamable(model)
    enc = model.encoder
    rel_pe = torch.from_numpy(espnet_rel_rows(left, right, enc.output_size))
    return {"encoder": enc, "rel_pe": rel_pe.to(enc.after_norm.weight.device)}


def espnet_input_transform(enc, x_new: torch.Tensor) -> torch.Tensor:
    """The rowwise espnet input pipeline on raw feature rows: the input
    layer (``linear``: proj, LN, [dropout], relu) and the sqrt(d) scale,
    the order of ``EspnetTransformerEncoder.forward``."""
    return enc.input_transform(x_new)[0] * math.sqrt(enc.output_size)


def _espnet_layer_step(layer, rel_pe: torch.Tensor, buf: torch.Tensor,
                       x_new: torch.Tensor, n_new: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, band_keys: torch.Tensor, *, left: int,
                       right: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One espnet pre-LN layer, one chunk a stream (JAX
    ``_espnet_layer_step``, ``vmap``ped): the contract of
    ``_batched_layer_step``.  Only the band's cells are scored; the BD term
    of offset ``m - L`` is ``(q_i + v) . p[m]``, with ``p`` the band's
    position rows through ``linear_pos``."""
    L, R = left, right
    attn = layer.self_attn
    H, dk = attn.h, attn.d_k
    N, C, D = x_new.shape
    K, W = L + R + C, L + R + 1
    rows = torch.arange(K, device=x_new.device)
    row_ok = (rows >= lo[:, None]) & (rows < hi[:, None])                  # (N, K)
    concat = torch.where(row_ok[..., None], torch.cat([buf, x_new], dim=1), 0.0)

    y = layer.norm1(concat)
    q = attn.linear_q(y[:, L:L + C]).view(N, C, H, dk)
    k = attn.linear_k(y).view(N, K, H, dk)
    v = attn.linear_v(y).view(N, K, H, dk)
    p = attn.linear_pos(rel_pe).view(W, H, dk)
    ac = torch.matmul((q + attn.pos_bias_u)[..., None, :], k.unfold(1, W, 1))[..., 0, :]
    bd = torch.einsum("nchd,mhd->nchm", q + attn.pos_bias_v, p)          # (N, C, H, W)
    invalid = ((band_keys < lo[:, None, None]) | (band_keys >= hi[:, None, None]))[:, :, None]
    score = ((ac + bd) / math.sqrt(dk)).masked_fill(invalid, NEG_INF)
    # espnet re-zeroes masked cells after the softmax
    prob = torch.softmax(score, dim=-1).masked_fill(invalid, 0.0)
    vec = torch.matmul(prob[..., None, :], v.unfold(1, W, 1).transpose(-1, -2))
    x_att = concat[:, L:L + C] + attn.linear_out(vec.reshape(N, C, H * dk))
    out = x_att + layer.feed_forward(layer.norm2(x_att))
    keep = (n_new[:, None] + torch.arange(L + R, device=x_new.device))[..., None]
    return concat.gather(1, keep.expand(-1, -1, D)), out


def batched_encode_step_espnet(prep: Dict, cache: Dict, x_new: torch.Tensor,
                               n_new: torch.Tensor, key_limit: torch.Tensor, *,
                               left: int, right: int
                               ) -> Tuple[Dict, torch.Tensor, torch.Tensor]:
    """The espnet twin of :func:`batched_encode_step`: ``x_new`` (N, C, F)
    raw feature rows through the input transform, the cached band layers
    and ``after_norm``; the caches hold the transformed streams (N,
    n_layer, L+R, D).  The same contract and returns."""
    enc = prep["encoder"]
    n_in, C = cache["n_in"], x_new.shape[1]
    L, R = left, right
    K, dev = L + R + C, x_new.device
    band_keys = (torch.arange(C, device=dev)[:, None]
                 + torch.arange(L + R + 1, device=dev)[None])
    x, bufs = espnet_input_transform(enc, x_new), []
    for k, layer in enumerate(enc.encoders):
        pos0 = n_in - k * R
        lo = (L + R - pos0).clamp(0, K)
        hi = torch.maximum(lo, torch.minimum(key_limit - pos0, n_new) + (L + R))
        buf, x = _espnet_layer_step(layer, prep["rel_pe"], cache["bufs"][:, k], x, n_new,
                                    lo, hi, band_keys, left=L, right=R)
        bufs.append(buf)
    new_cache = {"bufs": torch.stack(bufs, dim=1), "n_in": n_in + n_new}
    return new_cache, enc.after_norm(x), n_in - len(enc.encoders) * R


def incremental_encode_step_espnet(prep: Dict, cache: Dict, x_new: torch.Tensor,
                                   key_limit: Optional[int] = None, *, left: int,
                                   right: int) -> Tuple[Dict, torch.Tensor, int]:
    """The espnet twin of :func:`incremental_encode_step` (one stream,
    ``x_new`` (C, F) raw feature rows): the batched step on one stream."""
    n_in, C, dev = cache["n_in"], x_new.shape[0], x_new.device
    ints = torch.tensor([n_in, C, _BIG if key_limit is None else int(key_limit)],
                        device=dev)
    new, out, _ = batched_encode_step_espnet(
        prep, {"bufs": cache["bufs"][None], "n_in": ints[0:1]}, x_new[None],
        ints[1:2], ints[2:3], left=left, right=right)
    return ({"bufs": new["bufs"][0], "n_in": n_in + C}, out[0],
            n_in - len(prep["encoder"].encoders) * right)


def _family_steps(model, left: int, right: int, window_len: int):
    """``(layers, (n_layer, d_model), step, batched_step)`` of the model's
    family: ``step(layers, cache, x_new, key_limit)`` one stream,
    ``batched_step(layers, cache, x_new, n_new, key_limit)`` N streams."""
    if isinstance(model, EspnetTransducer):
        prep = prepare_espnet(model, left, right)
        enc = prep["encoder"]
        return (prep, (len(enc.encoders), enc.output_size),
                lambda p, c, x, kl: incremental_encode_step_espnet(
                    p, c, x, kl, left=left, right=right),
                lambda p, c, x, n, kl: batched_encode_step_espnet(
                    p, c, x, n, kl, left=left, right=right))
    layers = prepare_layers(model, left, right, window_len)
    d_model = layers[0]["layer"].MultiHeadAttention.dec_attn.qkv_net.in_features
    return (layers, (len(layers), d_model),
            lambda p, c, x, kl: incremental_encode_step(p, c, x, kl, left=left, right=right),
            lambda p, c, x, n, kl: batched_encode_step(p, c, x, n, kl, left=left,
                                                       right=right))


def make_incremental_encoder(model, cfg, batched: bool = False):
    """For the sessions: ``(layers, (n_layer, d_model), step)``, the
    family's cached-encoder step (native: the closed form with the wrap
    pinned to ``cfg.window_len``; espnet: the shift-invariant band).
    ``step(layers, cache, x_new, key_limit) -> (cache, out, out_start)``,
    or with ``batched`` ``step(layers, cache, x_new, n_new, key_limit)``
    over N streams (``init_batched_cache``'s layout).  ``d_model`` is the
    width of the cached streams."""
    layers, geom, step, batched_step = _family_steps(
        model, cfg.left_context, cfg.right_context, cfg.window_len)
    return layers, geom, batched_step if batched else step


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
    ``key_limit`` when comparing with another window geometry.  Either
    family."""
    layers, (n_layer, d_model), step, _ = _family_steps(model, left, right, window_len)
    device = next(model.parameters()).device
    cache = init_cache(n_layer, left, right, d_model, device)
    t = features.shape[0]
    lag = n_layer * right
    padded = np.concatenate([features, np.zeros((lag, features.shape[1]), np.float32)])
    if key_limit is None:
        key_limit = chunked_encode_key_limit(t, n_layer * left, lag,
                                             max(lag, 1), window_len)
    outs = []
    for p in range(0, padded.shape[0], chunk):
        rows = torch.from_numpy(padded[p:p + chunk]).to(device)
        cache, out, s = step(layers, cache, rows, key_limit)
        lo, hi = max(0, -s), min(rows.shape[0], t - s)
        if hi > lo:
            outs.append(out[lo:hi])
    return torch.cat(outs).cpu().numpy()
