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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from transformer_transducer_tpu_torch.models.attention import TransformerXLLayer
from transformer_transducer_tpu_torch.ops.masks import look_ahead_mask
from transformer_transducer_tpu_torch.utils.device import resolve_device


class AudioEncoder(nn.Module):
    def __init__(self, n_layer: int, k_len: int, n_head: int, d_model: int,
                 d_head: int, d_inner: int, dropout: float = 0.0,
                 flash: bool = False):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerXLLayer(k_len, n_head, d_model, d_head, d_inner,
                               dropout, flash) for _ in range(n_layer)])

    def forward(self, inputs: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                band: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        x = inputs
        for layer in self.layers:
            x = layer(x, attn_mask, band)
        return x


class LabelEncoder(nn.Module):
    def __init__(self, vocab_size: int, n_layer: int, k_len: int, n_head: int,
                 d_model: int, d_head: int, d_inner: int, dropout: float = 0.0):
        super().__init__()
        self.dec_embedding = nn.Embedding(vocab_size, d_model)
        self.layers = nn.ModuleList([
            TransformerXLLayer(k_len, n_head, d_model, d_head, d_inner, dropout)
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
    def __init__(self, input_size: int, inner_dim: int, vocab_size: int,
                 tied: bool = False):
        super().__init__()
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
        return self.logits_from(self.forward_layer(torch.cat([enc_state, dec_state], -1)),
                                tied_projection)

    # forward_layer(cat(e, d)) == project_enc(e) + project_dec(d): a decoder
    # that holds one side fixed applies that side's half once
    def project_enc(self, enc_state: torch.Tensor) -> torch.Tensor:
        """The first layer's encoder half, with its bias."""
        w = self.forward_layer.weight
        return nn.functional.linear(enc_state, w[:, :enc_state.shape[-1]],
                                    self.forward_layer.bias)

    def project_dec(self, dec_state: torch.Tensor) -> torch.Tensor:
        """The first layer's label half, no bias."""
        w = self.forward_layer.weight
        return dec_state @ w[:, w.shape[1] - dec_state.shape[-1]:].t()

    def logits_from(self, pre: torch.Tensor,
                    tied_projection: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits from the first layer's pre-activation."""
        h = torch.tanh(pre)
        if tied_projection is not None:
            return h @ tied_projection.t() + self.project_bias
        return self.project_layer(h)


class Transducer(nn.Module):
    """Audio encoder + label encoder + joint network.

    ``enc``/``dec``: (n_layer, k_len, n_head, d_model, d_head, d_inner).
    ``flash``: unmasked encoder attention goes through the flash kernel.
    ``band``: ``(left, right)`` trains (``encode_both``) the encoder under
    the streaming band through the banded kernel.  As in the JAX package this
    deviates on purpose from the reference, which trains every config with no
    audio mask and only decodes with the band.
    """

    def __init__(self, vocab_size: int, enc: Tuple[int, ...],
                 dec: Tuple[int, ...], joint_inner: int, dropout: float = 0.0,
                 share_embedding: bool = False, flash: bool = False,
                 band: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.vocab_size = vocab_size
        self.share_embedding = share_embedding
        self.band = band
        self.encoder = AudioEncoder(*enc, dropout=dropout, flash=flash)
        self.decoder = LabelEncoder(vocab_size, *dec, dropout=dropout)
        self.joint = JointNetwork(enc[3] + dec[3], joint_inner, vocab_size,
                                  tied=share_embedding)

    def forward(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Full-logits forward: (B,T,D), (B,U) -> (B,T,U+1,V): blank-prefixed
        targets, look-ahead label mask, no audio mask (``tt/model.py:58-68``)."""
        return self.joint_logits(*self.encode_both(inputs, targets))

    def encode_both(self, inputs: torch.Tensor, targets: torch.Tensor):
        """Encoder + label-encoder states, the training hot path (the fused
        loss consumes them; no (B,T,U,V) tensor)."""
        prefixed = nn.functional.pad(targets, (1, 0))            # blank prefix
        label_mask = look_ahead_mask(prefixed.shape[1], device=targets.device)
        return (self.encoder(inputs, band=self.band),
                self.decoder(prefixed, label_mask))

    def encode(self, inputs: torch.Tensor,
               attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encoder(inputs, attn_mask)

    def encode_banded(self, inputs: torch.Tensor, left: int, right: int) -> torch.Tensor:
        """Streaming-band encoding through the banded kernel; numerically
        ``encode(inputs, context_mask(T, left, right))``."""
        return self.encoder(inputs, band=(left, right))

    def predict(self, tokens: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Label-encoder forward (reference inference passes no mask)."""
        return self.decoder(tokens, attn_mask)

    def joint_logits(self, enc_state: torch.Tensor,
                     dec_state: torch.Tensor) -> torch.Tensor:
        return self.joint(enc_state, dec_state, tied_projection=self._tied_projection())

    def joint_logits_from(self, pre: torch.Tensor) -> torch.Tensor:
        """Joint logits from ``joint.project_enc(e) + joint.project_dec(d)``."""
        return self.joint.logits_from(pre, self._tied_projection())

    def _tied_projection(self) -> Optional[torch.Tensor]:
        return self.decoder.dec_embedding.weight if self.share_embedding else None


def build_transducer(model_cfg, flash: bool = False, device=None,
                     banded: bool = False) -> Transducer:
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
                           flash=flash, band=band)
    return model.eval()
