"""The espnet-variant Transformer-Transducer model family (port of
``models/espnet_variant.py``).

The reference's second model family (``tt_espnet/model.py`` driven by
``train_esptt.py`` / ``config/espnet_aishell.yaml``), built from the
author-modified ESPnet pieces:

* ``RelPosMultiHeadAttention`` — biased q/k/v/out projections, a bias-free
  ``linear_pos`` over sinusoidal signed relative encodings, learnable
  ``pos_bias_u``/``pos_bias_v``, and the signed rel-shift, exact for every
  offset |i - j| < T (no wrap, unlike the native family's);
* pre-LN ``EspnetEncoderLayer`` with a final ``after_norm``;
* ``EspnetTransformerEncoder`` with the input layers None / ``embed`` /
  ``linear`` / ``conv2d`` / ``conv2d6`` / ``conv2d8``, the band ∧ pad ∧
  extra mask, the sqrt(d) input scale and the positional dropouts;
* the additive joint ``lin_out(act(lin_enc(enc) + lin_dec(dec)))`` with a
  bias-free ``lin_dec``;
* ``EspnetTransducer`` — sos = eos = V - 1 text prefix, encoder band
  ``model.mask.encoder_{left,right}_mask``, text band left
  ``decoder_left_mask`` / right 0.

Masks are True == masked, as in the rest of the port.  A masked score takes
``finfo(float32).min`` (-inf under bf16, as JAX rounds it) and the masked
cells are set back to 0 after the softmax, so a fully masked padded row
attends to nothing.

``compute_dtype=torch.bfloat16`` casts where the JAX module casts: the
attention's and the feed-forward's projections, the biases ``pos_bias_u``
/ ``pos_bias_v``, the scores and the joint run in bf16 (each projection a
bf16 product and a separate bf16 bias add, ``ops/precision.py``),
the softmax in float32; the input layers, the residual stream and the
LayerNorms stay float32.

Under tensor parallelism (``parallel/sharding.py::shard_model``) a rank
holds its heads of ``linear_q/k/v/pos`` and ``pos_bias_u/v`` and the
matching columns of ``linear_out``, its part of ``w_1``/``w_2`` and of the
joint's ``lin_enc``/``lin_dec``/``lin_out``; the products name their
collectives (``parallel/tensor.py``), row-parallel biases added after the
sum.  The input layers stay whole, as in JAX.

The modules are plain tensor code: the JAX module has no Pallas kernel, so
nothing here launches one.  Their ``state_dict`` keys are upstream espnet's
(``encoders.{i}.self_attn.linear_q.weight``, ``feed_forward.w_1``,
``norm1``, ``after_norm``, ``embed.0.weight``, ``embed.conv.{k}``,
``embed.out.0``, ``lin_enc``, ``lin_dec``, ``lin_out``), so the JAX
package's ``utils/torch_convert.py::espnet_transducer_params`` reads the
port's ``encoder``/``decoder``/``joint`` state dicts as they are.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from transformer_transducer_tpu_torch.models.attention import rel_shift
from transformer_transducer_tpu_torch.ops.activations import ACTIVATIONS
from transformer_transducer_tpu_torch.ops.masks import (
    combine_masks, context_mask, padding_mask)
from transformer_transducer_tpu_torch.ops.precision import (
    NEG_INF, dense, neg_inf, scalar, to_compute, widen)
from transformer_transducer_tpu_torch.ops.quant import QuantLinear, dense_kernel
from transformer_transducer_tpu_torch.parallel.tensor import (
    column_input, row_parallel, sharded_dropout)
from transformer_transducer_tpu_torch.utils.device import resolve_device

# (kernel, stride) of each VALID Conv2d of the subsampling stacks (espnet
# ``subsampling.py``: Conv2dSubsampling 1/4, Conv2dSubsampling6 1/6,
# Conv2dSubsampling8 1/8)
_CONV_STACKS = {
    "conv2d": ((3, 2), (3, 2)),
    "conv2d6": ((3, 2), (5, 3)),
    "conv2d8": ((3, 2), (3, 2), (3, 2)),
}


def sinusoid_rows(rel: np.ndarray, d_model: int) -> np.ndarray:
    """(len(rel), d) sinusoidal encodings of the signed relative positions
    ``rel`` (float64 angles, float32 rows: the JAX package's formula)."""
    inv = np.exp(np.arange(0, d_model, 2) * -(math.log(10000.0) / d_model))
    ang = rel[:, None] * inv[None, :]
    pe = np.zeros((len(rel), d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return pe


def rel_positional_encoding(length: int, d_model: int) -> np.ndarray:
    """(2L-1, d) signed relative encodings; row j encodes rel = L-1-j."""
    return sinusoid_rows((length - 1) - np.arange(2 * length - 1), d_model)


@functools.lru_cache(maxsize=32)
def _pos_table(length: int, d_model: int, device: torch.device) -> torch.Tensor:
    """``rel_positional_encoding`` on ``device``, made once per shape."""
    return torch.from_numpy(rel_positional_encoding(length, d_model)).to(device)


def rel_shift_signed(x: torch.Tensor) -> torch.Tensor:
    """(..., t, 2t-1) -> (..., t, t): out[i, j] = x[i, t-1 + j - i].

    The native ``rel_shift``'s pad/reshape trick truncated to the first t
    columns of the signed 2t-1-wide table; exact for every offset."""
    return rel_shift(x)[..., :x.shape[-2]]


class RelPosMultiHeadAttention(nn.Module):
    tp = None     # the mesh once shard_model has narrowed it

    def __init__(self, n_head: int, d_model: int, dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.h, self.d_k = n_head, d_model // n_head
        self.compute_dtype = compute_dtype
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, t, D), pos_emb (2t-1, D), attn_mask (t, t) or (B|1, t, t)."""
        b, t, _ = x.shape
        h, dk = self.pos_bias_u.shape[0], self.d_k   # this rank's heads
        cd = self.compute_dtype
        # once: JAX sums the three products' gradients in cd
        x = column_input(x, self.tp, cd)
        q = dense(self.linear_q, x, cd).view(b, t, h, dk)
        k = dense(self.linear_k, x, cd).view(b, t, h, dk)
        v = dense(self.linear_v, x, cd).view(b, t, h, dk)
        p = dense(self.linear_pos, pos_emb, cd).view(-1, h, dk)
        ac = torch.einsum("bind,bjnd->bnij", q + to_compute(self.pos_bias_u, cd), k)
        bd = torch.einsum("bind,jnd->bnij", q + to_compute(self.pos_bias_v, cd), p)
        scores = ac + rel_shift_signed(bd)                    # bd: (B,H,t,2t-1)
        # divided as JAX divides a bf16 tensor: by the bf16-rounded
        # constant, in float32, rounded once (torch would multiply a bf16
        # tensor by a float32 reciprocal)
        scores = (widen(scores) / scalar(math.sqrt(dk), scores.dtype)).to(scores.dtype)
        if attn_mask is not None:
            m = attn_mask[None, None] if attn_mask.dim() == 2 else attn_mask[:, None]
            scores = scores.masked_fill(m, neg_inf(scores.dtype))
        probs = torch.softmax(widen(scores), dim=-1)
        if attn_mask is not None:
            probs = probs.masked_fill(m, 0.0)       # espnet re-zeroes masked cells
        probs = sharded_dropout(self.dropout, probs.to(scores.dtype), self.tp, 1)
        out = torch.einsum("bnij,bjnd->bind", probs, v)
        return widen(row_parallel(self.linear_out, out.reshape(b, t, h * dk), self.tp, cd))


class EspnetFeedForward(nn.Module):
    tp = None     # the mesh once shard_model has narrowed it

    def __init__(self, d_model: int, d_inner: int, dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.w_1 = nn.Linear(d_model, d_inner)
        self.w_2 = nn.Linear(d_inner, d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``compute_dtype`` overrides the module's (the label cache runs
        float32)."""
        cd = compute_dtype or self.compute_dtype
        h = torch.relu(dense(self.w_1, column_input(x, self.tp, cd), cd))
        return widen(row_parallel(self.w_2, sharded_dropout(self.dropout, h, self.tp, -1),
                                  self.tp, cd))


class EspnetEncoderLayer(nn.Module):
    """Pre-LN layer: x + drop(attn(LN(x))), then x + drop(ff(LN(x)))."""

    def __init__(self, n_head: int, d_model: int, d_inner: int,
                 dropout: float = 0.0, attn_dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = RelPosMultiHeadAttention(n_head, d_model, attn_dropout,
                                                  compute_dtype)
        self.feed_forward = EspnetFeedForward(d_model, d_inner, dropout, compute_dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.dropout(self.self_attn(self.norm1(x), pos_emb, attn_mask))
        return x + self.dropout(self.feed_forward(self.norm2(x)))


def conv_subsampled_length(lengths, variant: str, t_in: int):
    """Valid lengths after a conv stack, as espnet's mask slicing gives
    them (``[:-2:2]`` per stride-2 conv, ``[:-4:3]`` for the stride-3 one):
    ``ceil(min(len, T - (k - 1)) / s)`` per conv."""
    t = t_in
    lengths = torch.as_tensor(lengths)
    for k, s in _CONV_STACKS[variant]:
        lengths = -(-torch.clamp(lengths, max=t - (k - 1)) // s)
        t = (t - k) // s + 1
    return lengths


class Conv2dSubsampling(nn.Module):
    """Conv2d subsampling front end (1/4, 1/6 or 1/8 time reduction):
    VALID Conv2d + ReLU over the (time, freq) plane, then a Linear over the
    channel-major flattened features (torch's ``view(b, t, c*f)``).  The
    state-dict keys are espnet's: ``conv.{0,2[,4]}`` and ``out.0``."""

    def __init__(self, idim: int, odim: int, variant: str = "conv2d"):
        super().__init__()
        self.variant = variant
        layers, c_in, f = [], 1, idim
        for k, s in _CONV_STACKS[variant]:
            layers += [nn.Conv2d(c_in, odim, k, s), nn.ReLU()]
            c_in, f = odim, (f - k) // s + 1
        self.conv = nn.Sequential(*layers)
        self.out = nn.Sequential(nn.Linear(odim * f, odim))

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor]):
        h = self.conv(x[:, None])                           # (B, C, T', F')
        b, c, t, f = h.shape
        h = self.out(h.transpose(1, 2).reshape(b, t, c * f))
        if lengths is None:
            return h, None
        return h, conv_subsampled_length(lengths, self.variant, x.shape[1])


class EspnetTransformerEncoder(nn.Module):
    """ESPnet-style encoder with banded masks and rel-pos attention.

    ``input_layer``: None (features already d_model wide), ``"embed"``
    (token embedding; espnet's ``padding_idx`` row, -1 == V - 1, embeds to
    zero), ``"linear"`` (projection + LN + dropout + relu) or
    ``"conv2d"``/``"conv2d6"``/``"conv2d8"`` (time-subsampling conv front
    ends; the band and pad masks are built at the subsampled rate)."""

    def __init__(self, output_size: int, attention_heads: int, linear_units: int,
                 num_blocks: int, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: Optional[str] = None,
                 input_size: Optional[int] = None,
                 padding_idx: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.output_size = output_size
        self.input_layer = input_layer
        self.input_size = input_size
        self.padding_idx = padding_idx
        if input_layer == "embed":
            self.embed = nn.Sequential(nn.Embedding(input_size, output_size))
        elif input_layer == "linear":
            self.embed = nn.Sequential(nn.Linear(input_size, output_size),
                                       nn.LayerNorm(output_size, eps=1e-5),
                                       nn.Dropout(dropout_rate), nn.ReLU())
        elif input_layer in _CONV_STACKS:
            self.embed = Conv2dSubsampling(input_size, output_size, input_layer)
        elif input_layer is not None:
            raise ValueError(f"unknown espnet input_layer {input_layer!r}")
        self.pos_drop = nn.Dropout(positional_dropout_rate)
        self.pos_drop_emb = nn.Dropout(positional_dropout_rate)
        self.encoders = nn.ModuleList([
            EspnetEncoderLayer(attention_heads, output_size, linear_units,
                               dropout_rate, attention_dropout_rate, compute_dtype)
            for _ in range(num_blocks)])
        self.after_norm = nn.LayerNorm(output_size, eps=1e-5)

    @property
    def pad_row(self) -> Optional[int]:
        """The embedding row that embeds to zero (espnet ``padding_idx``)."""
        if self.input_layer != "embed" or self.padding_idx is None:
            return None
        return self.padding_idx % self.input_size

    def input_transform(self, xs: torch.Tensor, lengths=None):
        """The input layer, before the sqrt(d) scale: ``(x, lengths)`` at
        the model rate."""
        if self.input_layer == "embed":
            x = self.embed(xs)
            if self.pad_row is not None:
                x = x * (xs != self.pad_row)[..., None].to(x.dtype)
            return x, lengths
        if self.input_layer in _CONV_STACKS:
            return self.embed(xs, lengths)
        if self.input_layer == "linear":
            return self.embed(xs), lengths
        return xs, lengths

    def forward(self, xs: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                left_mask: int = -1, right_mask: int = -1,
                extra_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x, lengths = self.input_transform(xs, lengths)
        t, dev = x.shape[1], x.device
        band = None
        if left_mask >= 0 or right_mask >= 0:
            band = context_mask(t, left_mask if left_mask >= 0 else t,
                                right_mask if right_mask >= 0 else t, device=dev)[None]
        pad = (padding_mask(torch.as_tensor(lengths, device=dev), t)[:, None, :]
               if lengths is not None else None)
        if extra_mask is not None and extra_mask.dim() == 2:
            extra_mask = extra_mask[None]
        mask = combine_masks(band, pad, extra_mask)

        x = self.pos_drop(x * math.sqrt(self.output_size))
        pos = self.pos_drop_emb(_pos_table(t, self.output_size, dev).to(x.dtype))
        for layer in self.encoders:
            x = layer(x, pos, mask)
        return self.after_norm(x), lengths


class AdditiveJointNetwork(nn.Module):
    """``lin_out(act(lin_enc(enc) + lin_dec(dec)))``, bias-free ``lin_dec``.

    The first layer is a sum of the two halves, each its own projection,
    so a decoder that holds one side fixed applies that side once; an
    int8 joint (each half W8A8 with its own activation scales, as in the
    JAX model) splits the same way; so does a bf16 one (the halves and
    their sum rounded to bf16, as in the JAX model)."""

    tp = None     # the mesh once shard_model has narrowed it

    def __init__(self, enc_dim: int, dec_dim: int, joint_space_size: int,
                 vocab_size: int, activation: str = "tanh",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.compute_dtype = compute_dtype
        self.lin_enc = nn.Linear(enc_dim, joint_space_size)
        self.lin_dec = nn.Linear(dec_dim, joint_space_size, bias=False)
        self.lin_out = nn.Linear(joint_space_size, vocab_size)

    @property
    def quant(self) -> bool:
        return isinstance(self.lin_out, QuantLinear)

    def project_enc(self, enc_state: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return dense(self.lin_enc, column_input(enc_state, self.tp, cd), cd)

    def project_dec(self, dec_state: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return dense(self.lin_dec, column_input(dec_state, self.tp, cd), cd)

    def first_layer(self, enc_half: torch.Tensor, dec_half: torch.Tensor) -> torch.Tensor:
        return enc_half + dec_half

    def logits_from(self, pre: torch.Tensor) -> torch.Tensor:
        return widen(row_parallel(self.lin_out, ACTIVATIONS[self.activation](pre),
                                  self.tp, self.compute_dtype))

    def forward(self, enc: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
        he, hd = self.project_enc(enc), self.project_dec(dec)
        if enc.dim() == 3 and dec.dim() == 3:
            return self.logits_from(he[:, :, None, :] + hd[:, None, :, :])
        return self.logits_from(he + hd)


class EspnetTransducer(nn.Module):
    """Encoder + sos-prefixed text encoder + additive joint.

    The surface is the native ``Transducer``'s (``sos``, here V - 1,
    ``joint_activation``, ``encode_for_loss``, ``encode_for_decoding``,
    ``encode_banded`` for the streaming sessions' windows, ``predict``,
    ``label_cache``, ``joint_logits``, ``joint_logits_from`` and
    ``joint_params``), plus ``encoded_lengths`` (conv input layers shorten
    the encoder output)."""

    tp = None     # the mesh once shard_model has narrowed it

    def __init__(self, vocab_size: int, enc_kwargs: dict, dec_kwargs: dict,
                 joint_space_size: int, joint_activation: str = "tanh",
                 encoder_left_mask: int = 10, encoder_right_mask: int = 2,
                 decoder_left_mask: int = 2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.compute_dtype = compute_dtype
        self.joint_activation = joint_activation
        self.encoder_left_mask = encoder_left_mask
        self.encoder_right_mask = encoder_right_mask
        self.decoder_left_mask = decoder_left_mask
        self.encoder = EspnetTransformerEncoder(**enc_kwargs,
                                                compute_dtype=compute_dtype)
        self.decoder = EspnetTransformerEncoder(**dec_kwargs,
                                                compute_dtype=compute_dtype)
        self.joint = AdditiveJointNetwork(enc_kwargs["output_size"],
                                          dec_kwargs["output_size"],
                                          joint_space_size, vocab_size,
                                          joint_activation, compute_dtype)

    @property
    def sos(self) -> int:
        return self.vocab_size - 1

    @property
    def quant(self) -> bool:
        return self.joint.quant

    def encode_both(self, speech, speech_lengths, text, text_lengths):
        """Encoder states under the band and the pad mask, and the
        sos-prefixed text encoder's states (the training hot path)."""
        return (self.encode(speech, speech_lengths),
                self.encode_text(text, text_lengths))

    def encode_text(self, text: torch.Tensor, text_lengths) -> torch.Tensor:
        text_in = nn.functional.pad(text, (1, 0), value=self.sos)
        dec, _ = self.decoder(text_in, torch.as_tensor(text_lengths) + 1,
                              self.decoder_left_mask, 0)
        return dec

    def encode_labels(self, text: torch.Tensor, text_lengths) -> torch.Tensor:
        """The label states the loss takes (:meth:`encode_text`)."""
        return self.encode_text(text, text_lengths)

    def encode_for_loss(self, speech: torch.Tensor, speech_lengths, text: torch.Tensor,
                        text_lengths):
        """``(enc, dec, t_len)`` for the loss: :meth:`encode_both` with the
        lengths as the pad masks, and the encoder's output lengths (a conv
        input layer shortens them)."""
        return (*self.encode_both(speech, speech_lengths, text, text_lengths),
                self.encoded_lengths(speech_lengths, speech.shape[1]))

    def encode(self, speech: torch.Tensor, speech_lengths=None) -> torch.Tensor:
        return self.encoder(speech, speech_lengths, self.encoder_left_mask,
                            self.encoder_right_mask)[0]

    def encode_for_decoding(self, inputs: torch.Tensor, t_len,
                            audio_mask: Optional[torch.Tensor] = None,
                            band: Optional[Tuple[int, int]] = None):
        """``(enc, t_len)`` for the decoders: the encoder with ``t_len`` as
        its pad mask, and ``encoded_lengths`` (JAX ``apps/predict.py``).
        The encoder bands itself (``model.mask``), so it takes neither
        ``audio_mask`` nor ``band``."""
        if audio_mask is not None or band is not None:
            raise ValueError("the espnet encoder bands itself (model.mask); "
                             "pass neither audio_mask nor band")
        t_len = torch.as_tensor(t_len, device=inputs.device)
        return self.encode(inputs, t_len), self.encoded_lengths(t_len, inputs.shape[1])

    def encode_banded(self, inputs: torch.Tensor, left: int, right: int) -> torch.Tensor:
        """The encoder under the band ``(left, right)`` with no pad mask,
        as the streaming sessions encode their windows (the sinusoidal
        encodings are shift-invariant, so no window length is pinned)."""
        return self.encoder(inputs, None, left, right)[0]

    def encoded_lengths(self, lengths, t_in: int):
        """Input-frame lengths -> encoder-output lengths: the identity
        unless the encoder has a conv-subsampling input layer."""
        if self.encoder.input_layer in _CONV_STACKS:
            return conv_subsampled_length(lengths, self.encoder.input_layer, t_in)
        return lengths

    def predict(self, tokens: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The text encoder over a token buffer under its band (left
        ``decoder_left_mask``, right 0), OR-combined with ``attn_mask``."""
        return self.decoder(tokens, None, self.decoder_left_mask, 0,
                            extra_mask=attn_mask)[0]

    def label_cache(self):
        """``(init_cache(batch, cap), step(tokens, cache, update_mask))`` of
        the KV-cached text encoder under its band
        (``decoding/espnet_label_cache.py``)."""
        # imported here: the cache module builds on this one
        from transformer_transducer_tpu_torch.decoding import espnet_label_cache
        left = int(self.decoder_left_mask)
        return (lambda b, cap: espnet_label_cache.init_cache(self.decoder, b, cap),
                lambda tok, cache, upd: espnet_label_cache.step(
                    self.decoder, tok, cache, upd, left=left))

    def joint_logits(self, enc: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
        return self.joint(enc, dec)

    def joint_logits_from(self, pre: torch.Tensor) -> torch.Tensor:
        """Logits from ``joint.first_layer(joint.project_enc(e),
        joint.project_dec(d))``."""
        return self.joint.logits_from(pre)

    def joint_params(self) -> Tuple[torch.Tensor, ...]:
        """(W_enc, W_dec, b1, W_out, b_out) of the additive joint as (in,
        out) matrices, the native ``Transducer.joint_params``'s form:
        ``lin_enc`` with its bias, the bias-free ``lin_dec`` and
        ``lin_out`` (JAX ``joint_params_from_espnet_variables``)."""
        joint = self.joint
        return (dense_kernel(joint.lin_enc).t(), dense_kernel(joint.lin_dec).t(),
                joint.lin_enc.bias, dense_kernel(joint.lin_out).t(), joint.lin_out.bias)


def is_espnet_config(model_cfg) -> bool:
    """Whether a ``model:`` block is of the espnet schema: it carries the
    family's ``mask`` block (reference ``config/espnet_aishell.yaml``)."""
    return model_cfg.mask is not None


def build_espnet_transducer(model_cfg, device=None,
                            compute_dtype: torch.dtype = torch.float32
                            ) -> EspnetTransducer:
    """An :class:`EspnetTransducer` from a reference-schema
    ``config/espnet_aishell.yaml`` model block, in eval mode on ``device``
    (``cuda`` unless the caller passes ``cpu``), computing in
    ``compute_dtype`` over float32 parameters."""
    def enc_args(blk, input_layer):
        return {"output_size": blk.output_size,
                "attention_heads": blk.attention_heads,
                "linear_units": blk.linear_units,
                "num_blocks": blk.num_blocks,
                "dropout_rate": blk.dropout_rate or 0.0,
                "positional_dropout_rate": blk.positional_dropout_rate or 0.0,
                "attention_dropout_rate": blk.attention_dropout_rate or 0.0,
                "input_layer": input_layer,
                "input_size": blk.input_size,
                "padding_idx": blk.padding_idx}

    with torch.device(resolve_device(device)):
        model = EspnetTransducer(
            vocab_size=model_cfg.joint.vocab_size,
            enc_kwargs=enc_args(model_cfg.enc, model_cfg.enc.input_layer),
            dec_kwargs=enc_args(model_cfg.dec, model_cfg.dec.input_layer or "embed"),
            joint_space_size=model_cfg.joint.joint_space_size,
            joint_activation=model_cfg.joint.joint_activation_type or "tanh",
            encoder_left_mask=model_cfg.mask.encoder_left_mask,
            encoder_right_mask=model_cfg.mask.encoder_right_mask,
            decoder_left_mask=model_cfg.mask.decoder_left_mask,
            compute_dtype=compute_dtype)
    return model.eval()
