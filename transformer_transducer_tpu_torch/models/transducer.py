"""The Transformer-Transducer model family, native variant (port of
``models/transducer.py``).

* ``AudioEncoder``  <- reference ``BuildEncoder`` (``tt/encoder.py:32-50``):
  N stacked rel-attention layers with per-layer position tables of
  ``k_len = max_input_length``; **no input projection** — stacked-fbank
  features must equal ``d_model``.
* ``LabelEncoder``  <- reference ``BuildDecoder`` (``tt/decoder.py:23-45``):
  ``Embedding(vocab, d_model, padding_idx=0)`` + layers with
  ``k_len = max_target_length``; token 0 embeds to zero.
* ``JointNetwork``  <- reference ``JointNet`` (``tt/model.py:12-39``):
  concat(enc, dec) -> Linear -> tanh -> Linear(vocab), with (B,T,U)
  broadcast and the optional tied projection (``tt/model.py:53-56``).
* ``Transducer``    <- reference ``Transducer`` (``tt/model.py:42-68``).

State-dict keys of ``encoder``, ``decoder`` and ``joint`` are the upstream
torch model's, so ``utils/torch_convert.py::transducer_params`` of the JAX
package reads them as they are.

``compute_dtype=torch.bfloat16`` computes in bf16 over float32 parameters
at the JAX module's rounding points (``ops/precision.py``), and
``remat`` recomputes each encoder layer in the backward
(``torch.utils.checkpoint``), as JAX's ``nn.remat``; the label encoder is
not recomputed.

Under tensor parallelism (``parallel/sharding.py::shard_model``) the joint's
``forward_layer`` is column-parallel and ``project_layer`` row-parallel
(``project_layer``'s bias added after the sum); a tied projection takes the
replicated embedding through ``copy_to_model`` and then this rank's inner
columns, so its gradient sums every rank's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from transformer_transducer_tpu_torch.decoding import label_cache
from transformer_transducer_tpu_torch.models.attention import TransformerXLLayer
from transformer_transducer_tpu_torch.ops.masks import look_ahead_mask
from transformer_transducer_tpu_torch.ops.precision import dense, widen
from transformer_transducer_tpu_torch.ops.quant import QuantLinear, dense_kernel
from transformer_transducer_tpu_torch.parallel.tensor import (
    column_input, copy_to_model, row_parallel, row_product)
from transformer_transducer_tpu_torch.utils.device import resolve_device


class AudioEncoder(nn.Module):
    input_layer = None            # the features are the first layer's input
    def __init__(self, n_layer: int, k_len: int, n_head: int, d_model: int,
                 d_head: int, d_inner: int, dropout: float = 0.0,
                 flash: bool = False, remat: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList([
            TransformerXLLayer(k_len, n_head, d_model, d_head, d_inner,
                               dropout, flash, compute_dtype) for _ in range(n_layer)])

    def forward(self, inputs: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                band: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        x = inputs
        # remat: keep only each layer's input and recompute the layer in the
        # backward, its dropout masks replayed from the saved random state
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = (checkpoint(layer, x, attn_mask, band, use_reentrant=False)
                 if remat else layer(x, attn_mask, band))
        return x


class LabelEncoder(nn.Module):
    def __init__(self, vocab_size: int, n_layer: int, k_len: int, n_head: int,
                 d_model: int, d_head: int, d_inner: int, dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dec_embedding = nn.Embedding(vocab_size, d_model)
        self.layers = nn.ModuleList([
            TransformerXLLayer(k_len, n_head, d_model, d_head, d_inner, dropout,
                               compute_dtype=compute_dtype)
            for _ in range(n_layer)])

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """padding_idx=0: token 0 embeds to an all-zero vector."""
        emb = self.dec_embedding(tokens)
        return emb * (tokens != 0)[..., None].to(emb.dtype)

    def forward(self, tokens: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.embed(tokens)
        for layer in self.layers:
            x = layer(x, attn_mask)
        return x


class JointNetwork(nn.Module):
    """Under bf16 (JAX ``JointNetwork(compute_dtype=bfloat16)``): the
    concatenation cast to bf16, ``forward_layer`` and ``project_layer`` bf16
    products each followed by its bf16 bias, the tanh in bf16, the logits
    cast to float32; a tied projection is a bf16 product plus the float32
    bias."""

    tp = None     # the mesh once shard_model has narrowed it

    def __init__(self, input_size: int, inner_dim: int, vocab_size: int,
                 tied: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.forward_layer = nn.Linear(input_size, inner_dim)
        if tied:
            # the output weight is the label embedding; only the bias is free
            self.project_bias = nn.Parameter(torch.zeros(vocab_size))
        else:
            self.project_layer = nn.Linear(inner_dim, vocab_size)

    def forward(self, enc_state: torch.Tensor, dec_state: torch.Tensor,
                tied_projection: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B,T,D)+(B,U,D) -> (B,T,U,V); matching-rank inputs are concatenated
        directly (the reference's vector-vector decode path)."""
        if enc_state.dim() == 3 and dec_state.dim() == 3:
            t, u = enc_state.shape[1], dec_state.shape[1]
            enc_state = enc_state[:, :, None, :].expand(-1, -1, u, -1)
            dec_state = dec_state[:, None, :, :].expand(-1, t, -1, -1)
        cat = column_input(torch.cat([enc_state, dec_state], -1), self.tp,
                           self.compute_dtype)
        return self.logits_from(dense(self.forward_layer, cat, self.compute_dtype),
                                tied_projection)

    # forward_layer(cat(e, d)) == project_enc(e) + project_dec(d): a decoder
    # that holds one side fixed applies that side's half once.  An int8
    # layer (W8A8) takes one activation scale for each row of the
    # concatenation, so it has no such split: there the halves are the
    # states themselves, and first_layer applies the layer to their
    # concatenation, as the JAX decoders' joint_logits does.  Under bf16
    # the halves are float32 sums of bf16-rounded operands, and first_layer
    # rounds their sum to bf16 once before the bf16 bias: JAX's one bf16
    # product over the concatenation, which two rounded halves are not.
    @property
    def quant(self) -> bool:
        return isinstance(self.forward_layer, QuantLinear)

    def project_enc(self, enc_state: torch.Tensor) -> torch.Tensor:
        """The first layer's encoder half, with its bias (int8: the state)."""
        if self.quant:
            return enc_state
        w = self.forward_layer.weight[:, :enc_state.shape[-1]]
        if self.compute_dtype != torch.float32:
            return self._half(enc_state, w)
        return nn.functional.linear(enc_state, w, self.forward_layer.bias)

    def project_dec(self, dec_state: torch.Tensor) -> torch.Tensor:
        """The first layer's label half, no bias (int8: the state)."""
        if self.quant:
            return dec_state
        w = self.forward_layer.weight
        w = w[:, w.shape[1] - dec_state.shape[-1]:]
        if self.compute_dtype != torch.float32:
            return self._half(dec_state, w)
        return dec_state @ w.t()

    def _half(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """A half's product under bf16: bf16-rounded operands, float32 sums."""
        cd = self.compute_dtype
        return x.to(cd).float() @ w.to(cd).float().t()

    def first_layer(self, enc_half: torch.Tensor, dec_half: torch.Tensor) -> torch.Tensor:
        """The first layer's pre-activation from the two halves
        (broadcasting over the leading dimensions)."""
        if self.quant:
            lead = torch.broadcast_shapes(enc_half.shape[:-1], dec_half.shape[:-1])
            return self.forward_layer(torch.cat([enc_half.expand(*lead, -1),
                                                 dec_half.expand(*lead, -1)], -1))
        cd = self.compute_dtype
        if cd != torch.float32:
            return (enc_half + dec_half).to(cd) + self.forward_layer.bias.to(cd)
        return enc_half + dec_half

    def logits_from(self, pre: torch.Tensor,
                    tied_projection: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits from the first layer's pre-activation."""
        cd = self.compute_dtype
        h = torch.tanh(pre)
        if tied_projection is not None:
            return widen(row_product(h, tied_projection.t(), self.tp, cd) + self.project_bias)
        return widen(row_parallel(self.project_layer, h, self.tp, cd))


class Transducer(nn.Module):
    """Audio encoder + label encoder + joint network.

    ``enc``/``dec``: (n_layer, k_len, n_head, d_model, d_head, d_inner).
    ``flash``: unmasked encoder attention goes through the flash kernel.
    ``band``: ``(left, right)`` trains (``encode_both``) the encoder under
    the streaming band through the banded kernel.  ``remat`` and
    ``compute_dtype``: see the module docstring.  As in the JAX package this
    deviates on purpose from the reference, which trains every config with no
    audio mask and only decodes with the band.

    The decoders, the losses and the streaming sessions see either family
    through the same surface: ``sos`` (the label history's seed, here
    blank 0), ``joint_activation``, ``encode_for_loss``,
    ``encode_for_decoding``, ``predict``, ``label_cache``, ``joint_logits``,
    ``joint_logits_from`` and ``joint_params``
    (``models/espnet_variant.py::EspnetTransducer`` has the same).
    """

    sos = 0                       # the history starts from blank
    joint_activation = "tanh"
    tp = None                     # the mesh once shard_model has narrowed it

    def __init__(self, vocab_size: int, enc: Tuple[int, ...],
                 dec: Tuple[int, ...], joint_inner: int, dropout: float = 0.0,
                 share_embedding: bool = False, flash: bool = False,
                 band: Optional[Tuple[int, int]] = None, remat: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.share_embedding = share_embedding
        self.band = band
        self.compute_dtype = compute_dtype
        self.encoder = AudioEncoder(*enc, dropout=dropout, flash=flash,
                                    remat=remat, compute_dtype=compute_dtype)
        self.decoder = LabelEncoder(vocab_size, *dec, dropout=dropout,
                                    compute_dtype=compute_dtype)
        self.joint = JointNetwork(enc[3] + dec[3], joint_inner, vocab_size,
                                  tied=share_embedding, compute_dtype=compute_dtype)

    def forward(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Full-logits forward: (B,T,D), (B,U) -> (B,T,U+1,V): blank-prefixed
        targets, look-ahead label mask, no audio mask (``tt/model.py:58-68``)."""
        return self.joint_logits(*self.encode_both(inputs, targets))

    def encode_both(self, inputs: torch.Tensor, targets: torch.Tensor):
        """Encoder + label-encoder states, the training hot path (the fused
        loss consumes them; no (B,T,U,V) tensor)."""
        return self.encoder(inputs, band=self.band), self.encode_labels(targets)

    def encode_labels(self, targets: torch.Tensor, u_len=None) -> torch.Tensor:
        """Label-encoder states of the blank-prefixed targets under the
        look-ahead mask (``u_len`` unused: padded labels are not masked, as
        in the reference)."""
        prefixed = nn.functional.pad(targets, (1, 0))            # blank prefix
        label_mask = look_ahead_mask(prefixed.shape[1], device=targets.device)
        return self.decoder(prefixed, label_mask)

    def encode_for_loss(self, inputs: torch.Tensor, t_len, targets: torch.Tensor,
                        u_len):
        """``(enc, dec, t_len)`` for the loss: :meth:`encode_both` (padded
        frames are not masked, as in the reference) and the frame counts
        unchanged."""
        return (*self.encode_both(inputs, targets), t_len)

    def encode(self, inputs: torch.Tensor,
               attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encoder(inputs, attn_mask)

    def encode_for_decoding(self, inputs: torch.Tensor, t_len,
                            audio_mask: Optional[torch.Tensor] = None,
                            band: Optional[Tuple[int, int]] = None):
        """``(enc, t_len)`` for the decoders: the encoder under
        ``audio_mask``, or under the streaming ``band=(left, right)``
        through ``encode_banded``, or, with neither, full-context; the
        frame counts unchanged."""
        if audio_mask is not None and band is not None:
            raise ValueError("pass audio_mask or band, not both")
        if band is not None:
            return self.encode_banded(inputs, *band), t_len
        return self.encode(inputs, audio_mask), t_len

    def encode_banded(self, inputs: torch.Tensor, left: int, right: int) -> torch.Tensor:
        """Streaming-band encoding through the banded kernel; numerically
        ``encode(inputs, context_mask(T, left, right))``."""
        return self.encoder(inputs, band=(left, right))

    def predict(self, tokens: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Label-encoder forward (reference inference passes no mask)."""
        return self.decoder(tokens, attn_mask)

    def label_cache(self):
        """``(init_cache(batch, cap), step(tokens, cache, update_mask))`` of
        the KV-cached label encoder (``decoding/label_cache.py``)."""
        return (lambda b, cap: label_cache.init_cache(self.decoder, b, cap),
                lambda tok, cache, upd: label_cache.step(self.decoder, tok, cache, upd))

    def joint_logits(self, enc_state: torch.Tensor,
                     dec_state: torch.Tensor) -> torch.Tensor:
        return self.joint(enc_state, dec_state, tied_projection=self._tied_projection())

    @property
    def quant(self) -> bool:
        """Whether the projections are int8 (JAX ``Transducer(quant=True)``;
        ``ops/quant.py::quantize_modules`` swaps them)."""
        return self.joint.quant

    def joint_logits_from(self, pre: torch.Tensor) -> torch.Tensor:
        """Joint logits from ``joint.first_layer(joint.project_enc(e),
        joint.project_dec(d))`` (for a float joint, the sum of the halves)."""
        return self.joint.logits_from(pre, self._tied_projection())

    def joint_params(self) -> Tuple[torch.Tensor, ...]:
        """(W_enc, W_dec, b1, W_out, b_out) of the joint as (in, out)
        matrices, which the fused and the pruned loss and the beam's split
        joint take: the concat Linear split by rows at the encoder width
        (its input width less the label embedding's), and a tied joint's
        output weight the label embedding.  Views of the parameters, so
        gradients reach them; an int8 joint's dequantised weights (JAX
        ``dense_kernel``)."""
        joint = self.joint
        w1 = dense_kernel(joint.forward_layer).t()              # (enc+dec, inner)
        d_enc = w1.shape[0] - self.decoder.dec_embedding.weight.shape[1]
        if self.share_embedding:
            w2, b2 = self._tied_projection().t(), joint.project_bias
        else:
            w2, b2 = dense_kernel(joint.project_layer).t(), joint.project_layer.bias
        return w1[:d_enc], w1[d_enc:], joint.forward_layer.bias, w2, b2

    def _tied_projection(self) -> Optional[torch.Tensor]:
        """The tied output weight (V, inner): the label embedding, under
        tensor parallelism this rank's inner columns of it."""
        if not self.share_embedding:
            return None
        emb = self.decoder.dec_embedding.weight
        if self.tp is None:
            return emb
        inner = self.joint.forward_layer.weight.shape[0]
        return copy_to_model(emb, self.tp).narrow(1, self.tp.model_rank * inner, inner)


def build_transducer(model_cfg, flash: bool = False, device=None,
                     banded: bool = False, remat: bool = False,
                     compute_dtype: torch.dtype = torch.float32) -> Transducer:
    """A :class:`Transducer` from a reference-schema ``model:`` block, in
    eval mode on ``device`` (``cuda`` unless the caller passes ``cpu``); a
    trainer calls ``.train()``.

    ``banded=True`` trains the encoder under the config's streaming band
    (``enc.left_context``/``enc.right_context``), see :class:`Transducer`.
    Like the reference (``tt/model.py:53``), tying is gated on the
    ``share_embedding`` key; the shipped configs' ``share_weight`` is ignored.
    """
    enc = (model_cfg.enc.n_layer, model_cfg.enc.max_input_length,
           model_cfg.enc.n_head, model_cfg.enc.d_model,
           model_cfg.enc.d_head, model_cfg.enc.d_inner)
    dec = (model_cfg.dec.n_layer, model_cfg.dec.max_target_length,
           model_cfg.dec.n_head, model_cfg.dec.d_model,
           model_cfg.dec.d_head, model_cfg.dec.d_inner)
    if bool(model_cfg.share_embedding) and model_cfg.joint.inner_size != dec[3]:
        raise ValueError("weight tying needs joint.inner_size == dec.d_model")
    band = None
    if banded:
        left, right = model_cfg.enc.left_context, model_cfg.enc.right_context
        if left is None or right is None:
            raise ValueError("banded training needs model.enc.left_context "
                             "and right_context")
        band = (int(left), int(right))
    with torch.device(resolve_device(device)):
        model = Transducer(vocab_size=model_cfg.vocab_size, enc=enc, dec=dec,
                           joint_inner=model_cfg.joint.inner_size,
                           dropout=model_cfg.dropout or 0.0,
                           share_embedding=bool(model_cfg.share_embedding),
                           flash=flash, band=band, remat=remat,
                           compute_dtype=compute_dtype)
    return model.eval()
