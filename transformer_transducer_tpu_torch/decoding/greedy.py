"""Batched greedy RNN-T decoding (port of ``decoding/greedy.py``).

Reference ``Transducer.decode``/``recognize`` (``tt/model.py:70-108``): start
from blank token 0, for each frame take ``argmax(joint(enc_t, dec_state))``;
on a non-blank emission append the token and take the label encoder's
state at the new last position; at most one emission per frame.

Like the JAX package, the whole batch advances frame by frame with a fixed
token budget, and the label encoder runs under the causal label mask (the
training-consistent choice; see the JAX module's docstring).  Frames where
no row emits skip the label encoder, as the JAX ``lax.cond`` does.

Both model families, through the surface they share: the history starts
from ``model.sos`` (blank 0, or sos = V - 1 for the espnet family,
``tt_espnet/model.py:86``), the KV cache is ``model.label_cache()``
(``decoding/label_cache.py``, or ``decoding/espnet_label_cache.py`` under
the espnet text band), and ``recognize`` encodes through
``model.encode_for_decoding`` (an espnet model with the lengths as its pad
mask, decoding over ``encoded_lengths``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from transformer_transducer_tpu_torch.ops.masks import look_ahead_mask

BLANK = 0     # the blank token, also the history seed of the native family


def predict_last_state(model, buf: torch.Tensor, count: torch.Tensor,
                       label_mask: torch.Tensor) -> torch.Tensor:
    """(N, U) token buffers -> (N, D) label-encoder state at position
    count-1, encoding the whole buffer under ``label_mask``."""
    dec = model.predict(buf, label_mask)
    return dec[torch.arange(buf.shape[0], device=buf.device), count - 1]


@torch.no_grad()
def greedy_decode(model, enc_states: torch.Tensor, t_len, max_tokens: int = 43,
                  use_cache: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy decode.

    Args:
      enc_states: (B, T, D) encoder output.
      t_len: (B,) valid frame counts.
      max_tokens: token budget (>= 1 + longest expected emission).
      use_cache: KV-cached incremental label encoding (same numbers under
        the causal mask and the espnet text band; see
        ``decoding/label_cache.py`` and ``decoding/espnet_label_cache.py``).
    Returns:
      tokens: (B, max_tokens) with tokens[:, 0] == the family's seed (blank
        0, or sos = V - 1 for the espnet family),
      counts: (B,) number of valid entries in ``tokens`` (including seed).
    """
    b, t_max, _ = enc_states.shape
    device = enc_states.device
    t_len = torch.as_tensor(t_len, device=device)
    rows = torch.arange(b, device=device)
    label_mask = look_ahead_mask(max_tokens, device=device)
    buf = torch.full((b, max_tokens), BLANK, dtype=torch.long, device=device)
    buf[:, 0] = model.sos
    count = torch.ones((b,), dtype=torch.long, device=device)

    if use_cache:
        init_cache, lc_step = model.label_cache()
        cache = init_cache(b, max_tokens)
        dec_state, cache = lc_step(buf[:, 0], cache,
                                   torch.ones((b,), dtype=torch.bool, device=device))
    else:
        dec_state = predict_last_state(model, buf, count, label_mask)

    for t in range(t_max):
        logits = model.joint_logits(enc_states[:, t], dec_state)
        pred = logits.argmax(-1)
        valid = (t < t_len) & (pred != BLANK) & (count < max_tokens)
        if not bool(valid.any()):
            continue
        pos = torch.where(valid, count, 0)
        buf[rows, pos] = torch.where(valid, pred, buf[rows, pos])
        count = count + valid.long()
        if use_cache:
            out, cache = lc_step(pred, cache, valid)
        else:
            out = predict_last_state(model, buf, count, label_mask)
        dec_state = torch.where(valid[:, None], out, dec_state)
    return buf, count


def tokens_to_lists(tokens: np.ndarray, counts: np.ndarray) -> List[List[int]]:
    """Strip the seed and padding -> python lists (the reference
    returns ``token_list[1:]``, ``tt/model.py:90``)."""
    return [list(map(int, tokens[i, 1:counts[i]])) for i in range(len(counts))]


@torch.no_grad()
def recognize(model, inputs: torch.Tensor, t_len,
              audio_mask: Optional[torch.Tensor] = None,
              band: Optional[Tuple[int, int]] = None,
              max_tokens: int = 43) -> List[List[int]]:
    """Offline recognition: encoder + batched greedy decode.

    The encoder runs under ``audio_mask`` (the dense path), or under the
    streaming ``band=(left, right)`` through ``encode_banded``, or, with
    neither, full-context (the flash kernel when the model was built with
    ``flash=True``).  Like the JAX ``recognize``, padded frames of a batch
    are not masked out of the keys.  An espnet model bands itself
    (``model.mask``) and takes neither: it encodes with ``t_len`` as its pad
    mask and decodes over ``encoded_lengths`` (JAX ``apps/predict.py``).
    """
    enc, t_len = model.encode_for_decoding(inputs, t_len, audio_mask, band)
    tokens, counts = greedy_decode(model, enc, t_len, max_tokens)
    return tokens_to_lists(tokens.cpu().numpy(), counts.cpu().numpy())


@torch.no_grad()
def decode_reference_exact(model, enc_states_b: torch.Tensor, t_len_b: int,
                           blank: int = BLANK) -> List[int]:
    """The reference's unmasked greedy loop for ONE utterance
    (``tt/model.py:70-90``), dynamic shapes: the label encoder re-run over
    the whole history with no mask after each emission (the espnet text
    encoder under its band, from sos).  A test oracle for
    :func:`greedy_decode` (which runs under the causal mask)."""
    tokens = [model.sos]

    def dec_last():
        buf = torch.tensor([tokens], dtype=torch.long, device=enc_states_b.device)
        return model.predict(buf, None)[0, -1]

    dec_state = dec_last()
    for t in range(int(t_len_b)):
        pred = int(model.joint_logits(enc_states_b[t], dec_state).argmax())
        if pred != blank:
            tokens.append(pred)
            dec_state = dec_last()
    return tokens[1:]
