"""Width-5 beam search (port of ``decoding/beam.py``).

The reference algorithm (``tt/model.py:110-179``), kept with its quirks,
because it defines what users see:

* the frame axis advances gated on the CURRENT BEST hypothesis: a frame
  expands the beams only when ``argmax(joint(enc_t, dec_best))`` is
  non-blank; there is no per-hypothesis blank continuation;
* on expansion every hypothesis proposes its top-width non-blank tokens;
* the width x width children reduce to the best ``width`` by total
  log-prob; the first expansion seeds the beams from the best
  hypothesis's top-width tokens instead (all initial beams are equal);
* the result is the best beam, the blank seed stripped.

As in the JAX package the label encoder runs under the causal label mask
(``decoding/greedy.py``), batched over all beams, and the search jumps from
emission to emission: one joint over a window of ``GATE_CHUNK`` frames a
row finds each row's next expanding frame.  The joint is applied through
its split weights (``model.joint_params()``): the encoder half of
every frame once, the label half on expansion.  For an int8 model those
are the dequantised weights, as in JAX (``ops/quant.py::dense_kernel``),
while the label encoder runs W8A8.

Both model families, through the surface they share: the espnet
family's additive joint has the same split form (its
``joint_activation``, ``tanh`` or ``relu``, in place of ``tanh``), its
label history seeds with ``model.sos`` = V - 1, and its KV cache
(``model.label_cache()``, ``decoding/espnet_label_cache.py``) holds
distance tables that are the same for every row and are not gathered.

The JAX loop is one ``lax.while_loop``; here it is an eager loop that
reads the card once an iteration (did any row expand, does any row go on,
in one copy).  Ties among equal scores break as ``lax.top_k`` and
``jnp.argsort`` break them, lower index first (stable sorts).
"""

from __future__ import annotations

import copy
import heapq
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from transformer_transducer_tpu_torch.decoding.greedy import (
    BLANK, predict_last_state)
from transformer_transducer_tpu_torch.ops.masks import look_ahead_mask
from transformer_transducer_tpu_torch.ops.activations import ACTIVATIONS

NEG = -1e30
GATE_CHUNK = 32  # frames a row in one gate window of the emission-jump loop


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, best first, the lower index
    first among equals (``lax.top_k``; ``torch.topk`` promises no order
    among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_search_batched(model, enc_states: torch.Tensor, t_len, beam_width: int = 5,
                        max_tokens: int = 43, blank: int = BLANK,
                        use_cache: bool = True, stats: Optional[Dict] = None,
                        observe: Optional[Callable[[Dict], None]] = None):
    """Beam search over a batch.  Returns (tokens (B, W, U), counts (B, W),
    scores (B, W)), best first.

    ``use_cache``: the KV-cached label encoder, parent-gathered on every
    expansion (``decoding/label_cache.py``), instead of re-encoding all W
    histories; the same numbers (the histories never shift; the cap only
    stops appends).  ``stats``, if given, gets the loop's ``iterations``
    and ``host_reads``; ``observe``, if given, is called each iteration
    with its decisions and the scores they were made on (to replay a
    near-tie).  Either family; a joint whose split weights
    (``model.joint_params()``) cannot be read raises ``ValueError``.
    """
    try:
        jp = model.joint_params()
    except AttributeError as err:
        raise ValueError(f"beam_search_batched: unrecognized joint layout ({err})") from err
    return _beam_run(model, jp, enc_states, t_len, beam_width, max_tokens, blank,
                     use_cache, stats, observe)


@torch.no_grad()
def _beam_run(model, jp, enc_states: torch.Tensor, t_len, w: int, max_tokens: int,
              blank: int, use_cache: bool, stats: Optional[Dict],
              observe: Optional[Callable[[Dict], None]]):
    """The emission-jump search (JAX ``_beam_run``).  Between expansions
    every frame is a no-op, so one gate joint over ``GATE_CHUNK`` frames a
    row, each row at its own frame cursor, jumps every row to its next
    expanding frame; iterations are about the most expansions of one row
    plus T / GATE_CHUNK."""
    b, t_max, _ = enc_states.shape
    device = enc_states.device
    k = GATE_CHUNK
    seed = model.sos                    # blank, or sos for the espnet family
    act = ACTIVATIONS[model.joint_activation]
    reads = 0
    if isinstance(t_len, torch.Tensor):
        t_len_host = t_len.tolist()
        reads += int(t_len.is_cuda)
    else:
        t_len_host = [int(n) for n in t_len]
    t_len = torch.tensor(t_len_host, dtype=torch.long, device=device)
    rows = torch.arange(b, device=device)
    label_mask = look_ahead_mask(max_tokens, device=device)

    w_enc, w_dec, b1, w_out, b_out = jp
    # the encoder half of every frame, once; padded so that a row's gate
    # window never runs off the end
    enc_proj = torch.nn.functional.pad(enc_states @ w_enc + b1, (0, 0, 0, k))

    def joint_split(he: torch.Tensor, hd: torch.Tensor) -> torch.Tensor:
        return act(he + hd) @ w_out + b_out

    def compute_dec_proj(beams, counts):
        dec = predict_last_state(model, beams.reshape(b * w, max_tokens),
                                 counts.reshape(b * w), label_mask)
        return (dec @ w_dec).reshape(b, w, -1)

    beams = torch.full((b, w, max_tokens), blank, dtype=torch.long, device=device)
    beams[:, :, 0] = seed
    counts = torch.ones((b, w), dtype=torch.long, device=device)
    probs = torch.zeros((b, w), device=device)
    first = torch.ones((b,), dtype=torch.bool, device=device)
    cur_t = torch.zeros((b,), dtype=torch.long, device=device)
    if use_cache:
        init_cache, lc_step = model.label_cache()
        cache = init_cache(b * w, max_tokens)
        x0, cache = lc_step(torch.full((b * w,), seed, dtype=torch.long, device=device),
                            cache, torch.ones((b * w,), dtype=torch.bool, device=device))
        dec_proj = (x0 @ w_dec).reshape(b, w, -1)
    else:
        dec_proj = compute_dec_proj(beams, counts)
    stale = False                       # dec_proj lags an expansion (no cache)
    go = any(n > 0 for n in t_len_host)
    iterations = 0
    win = torch.arange(k, device=device)
    while go:
        iterations += 1
        if stale:
            dec_proj, stale = compute_dec_proj(beams, counts), False
        best = probs.argmax(1)                                   # (B,)
        dp_best = dec_proj[rows, best]                           # (B, J)

        # the gate over each row's K-frame window: the next frame whose
        # argmax is non-blank under the current best hypothesis
        win_idx = cur_t[:, None] + win                           # (B, K)
        gate = joint_split(enc_proj[rows[:, None], win_idx], dp_best[:, None])
        cand = (gate.argmax(-1) != blank) & (win_idx < t_len[:, None])
        expand = cand.any(1)
        emit_t = torch.where(expand, cur_t + cand.to(torch.uint8).argmax(1),
                             torch.minimum(cur_t + k, t_len))

        # every beam's candidates at its row's emission frame
        enc_pt = enc_proj[rows, emit_t.clamp(max=t_max - 1)][:, None]
        logp = torch.log_softmax(joint_split(enc_pt, dec_proj), -1)   # (B, W, V)
        logp[:, :, blank] = NEG                                  # non-blank top-w
        vals, idxs = _top_k(logp, w)                             # (B, W, W)

        # children: the first expansion seeds from the best row; later ones
        # take the top w of w x w
        child_first, tok_first = vals[rows, best], idxs[rows, best]
        flat = (probs[:, :, None] + vals).reshape(b, w * w)
        top_vals, top_flat = _top_k(flat, w)
        tok_grid = idxs.reshape(b, w * w).gather(1, top_flat)
        f = first[:, None]
        new_probs = torch.where(f, child_first, top_vals)
        parents = torch.where(f, best[:, None].expand(b, w), top_flat // w)
        new_toks = torch.where(f, tok_first, tok_grid)

        src_beams = beams.gather(1, parents[:, :, None].expand(-1, -1, max_tokens))
        src_counts = counts.gather(1, parents)
        src_probs = probs.gather(1, parents)
        can_append = src_counts < max_tokens
        appended = src_beams.scatter(2, torch.where(can_append, src_counts, 0)[..., None],
                                     new_toks[..., None])
        appended = torch.where(can_append[..., None], appended, src_beams)
        # a full buffer keeps its parent's score: a token that was not
        # appended is never credited (phantom-score inflation)
        new_probs = torch.where(can_append, new_probs, src_probs)

        if observe is not None:
            observe({"first": first, "cur_t": cur_t, "win_idx": win_idx, "gate": gate,
                     "expand": expand, "emit_t": emit_t, "logp": logp, "flat": flat,
                     "best": best, "parents": parents, "new_toks": new_toks})
        e = expand[:, None]
        beams = torch.where(e[..., None], appended, beams)
        counts = torch.where(e, src_counts + can_append.long(), counts)
        probs = torch.where(e, new_probs, probs)
        first = first & ~expand
        cur_t = torch.where(expand, emit_t + 1, emit_t)
        # the iteration's one read of the card
        any_expand, go = torch.stack([expand.any(), (cur_t < t_len).any()]).tolist()
        reads += 1
        if not any_expand:
            continue
        if not use_cache:
            stale = True
            continue
        # parent-gather every beam's KV cache, append the one new token and
        # refresh the label half of the joint
        def g2(a):                      # (B, W, ...) gathered by parents along W
            return a[rows[:, None], parents]

        def gboth(c):                   # a cache leaf (B*W, ...) -> parent rows
            return g2(c.reshape(b, w, *c.shape[1:])).reshape(c.shape)

        # batch-independent leaves (the espnet distance tables) stay
        gathered = {**cache, "k": [gboth(c) for c in cache["k"]],
                    "v": [gboth(c) for c in cache["v"]], "idx": gboth(cache["idx"])}
        x, new_cache = lc_step(new_toks.reshape(b * w), gathered,
                               (e & can_append).reshape(b * w))
        dp = torch.where(can_append[..., None], (x @ w_dec).reshape(b, w, -1),
                         g2(dec_proj))
        dec_proj = torch.where(e[..., None], dp, dec_proj)
        # rows of an entry that did not expand keep their own cache (the
        # parent rows would reshuffle them)
        row_e = expand.repeat_interleave(w)

        def merge(new, old):
            return torch.where(row_e.view(-1, *([1] * (new.dim() - 1))), new, old)

        cache = {**cache,
                 "k": [merge(n, o) for n, o in zip(new_cache["k"], cache["k"])],
                 "v": [merge(n, o) for n, o in zip(new_cache["v"], cache["v"])],
                 "idx": merge(new_cache["idx"], cache["idx"])}

    if stats is not None:
        stats.update(iterations=iterations, host_reads=reads)
    order = torch.argsort(-probs, dim=1, stable=True)
    beams = beams.gather(1, order[:, :, None].expand(-1, -1, max_tokens))
    return beams, counts.gather(1, order), probs.gather(1, order)


def beam_search(model, enc_states_b: torch.Tensor, t_len_b: int, beam_width: int = 5,
                max_tokens: int = 43, blank: int = BLANK,
                stats: Optional[Dict] = None) -> List[int]:
    """One utterance's (T, D) encoder rows; returns the best token list."""
    beams, counts, _ = beam_search_batched(model, enc_states_b[None], [int(t_len_b)],
                                           beam_width, max_tokens, blank, stats=stats)
    n = int(counts[0, 0])
    return beams[0, 0, 1:n].tolist()


@torch.no_grad()
def recognize_beam(model, inputs: torch.Tensor, t_len,
                   audio_mask: Optional[torch.Tensor] = None,
                   band: Optional[Tuple[int, int]] = None, beam_width: int = 5,
                   max_tokens: int = 43, use_cache: bool = True,
                   stats: Optional[Dict] = None) -> List[List[int]]:
    """Offline recognition by beam search (reference
    ``recognize_beam_search``, ``tt/model.py:181-198``): the encoder as
    :func:`~decoding.greedy.recognize` runs it (``audio_mask``, the
    streaming ``band`` through ``encode_banded``, or full context), then
    :func:`beam_search_batched` (an espnet model encodes with ``t_len``
    and searches over its ``encoded_lengths``)."""
    enc, t_len = model.encode_for_decoding(inputs, t_len, audio_mask, band)
    beams, counts, _ = beam_search_batched(model, enc, t_len, beam_width, max_tokens,
                                           use_cache=use_cache, stats=stats)
    beams, counts = beams[:, 0].cpu().numpy(), counts[:, 0].cpu().numpy()
    return [list(map(int, beams[i, 1:counts[i]])) for i in range(len(counts))]


@torch.no_grad()
def beam_search_reference_exact(model, enc_states_b: torch.Tensor, t_len_b: int,
                                beam_width: int = 5) -> List[int]:
    """The reference's beam search for ONE utterance (``tt/model.py:
    110-179``), dynamic shapes: its unmasked label encoding, top-(w+1)
    minus blank, first-iteration seeding and ``heapq.nlargest``
    tie-breaking.  A test oracle (the batched search runs under the causal
    label mask)."""
    w = beam_width
    device = enc_states_b.device

    def dec_last(tokens):
        buf = torch.tensor([tokens], dtype=torch.long, device=device)
        return model.predict(buf, None)[0, -1]

    def softmax_np(tokens, t):
        logits = model.joint_logits(enc_states_b[t], dec_last(tokens))
        return torch.softmax(logits, -1).cpu().numpy()

    token_list = [[0] for _ in range(w)]
    probability = np.zeros((w,), dtype=float)
    token_child_list = [[[0] for _ in range(w)] for _ in range(w)]
    probability_child = np.zeros((w, w), dtype=float)
    first = True

    for t in range(int(t_len_b)):
        max_index = int(probability.argmax())
        out = softmax_np(token_list[max_index], t)
        if int(out.argmax()) == 0:
            continue
        for token_index in range(w):
            out = softmax_np(token_list[token_index], t)
            order = np.argsort(-out, kind="stable")[:w + 1]
            values = [float(out[i]) for i in order]
            indices = [int(i) for i in order]
            if 0 in indices:
                zi = indices.index(0)
                indices.pop(zi)
                values.pop(zi)
            else:
                indices.pop(-1)
                values.pop(-1)
            if first:
                for i in range(len(indices)):
                    token_child_list[i][token_index].append(indices[i])
                probability_child[:, token_index] = np.log(values)
            else:
                for i in range(len(indices)):
                    token_child_list[token_index][i].append(indices[i])
                probability_child[token_index] = (probability[token_index]
                                                  + np.log(values))
        if first:
            first = False
            for i in range(w):
                token_list[i] = copy.deepcopy(token_child_list[i][0])
                probability[i] = probability_child[i, 0]
        else:
            top = heapq.nlargest(w, range(w * w), probability_child.take)
            new_tokens, new_probs = [], np.zeros((w,))
            for i, idx in enumerate(top):
                new_probs[i] = probability_child[idx // w, idx % w]
                new_tokens.append(copy.deepcopy(token_child_list[idx // w][idx % w]))
            token_list, probability = new_tokens, new_probs
    return token_list[int(probability.argmax())][1:]
