"""Judging greedy transducer decoding against the plain model.

Greedy decoding reads the joint at each frame ``t`` with the history of
the ``n`` labels emitted so far, takes the arg-max, and on a label emits
it and moves to the next frame with the longer history (at most one label
a frame, and none once the history holds ``max_tokens - 1`` labels).  A
token list that greedy decoding served fixes the labels but not the frames
they came at.  :func:`gaps` therefore finds, over every alignment of the
list to the utterance's frames, the least value of the widest gap along
it, where a decision's gap is how far the chosen token's reference logit
lies below the reference's best at that frame and history.  A served list
that the plain model would give reads 0; one off by rounding reads a few
rounding steps of a logit; a wrong label reads the distance to the best.

Given a control's first tokens, it also reads, along that best alignment, the
gap of the token the control puts first at each decision.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.reference import model as M

INF = float("inf")


def label_states(histories: List[List[int]], w: Dict, dec: Dict, device) -> torch.Tensor:
    """(B, N + 1, D) label states of each history's prefixes (blank first),
    zero-padded to the longest."""
    n = max(len(h) for h in histories) + 1
    buf = torch.zeros((len(histories), n), dtype=torch.long, device=device)
    for i, h in enumerate(histories):
        buf[i, 1:len(h) + 1] = torch.as_tensor(h, dtype=torch.long)
    return M.encode_labels(buf, w, dec)


def decision_gaps(enc: torch.Tensor, dec: torch.Tensor, tokens: List[int], w: Dict,
                  first: Optional[torch.Tensor] = None):
    """(blank gap (T, N + 1), label gap (T, N), control gap (T, N + 1) or
    None) of one utterance: its (T, D) encoder states, (N + 1, D) label
    states and N served tokens; ``first`` (T, N + 1) is the token a
    control puts first at each decision."""
    logits = M.joint_logits(enc[:, None, :], dec[None, :, :], w)          # (T, N+1, V)
    best = logits.max(-1).values
    g_blank = best - logits[..., 0]
    y = torch.as_tensor(tokens, dtype=torch.long, device=enc.device)
    g_label = best[:, :-1] - logits[:, torch.arange(len(tokens), device=enc.device), y]
    g_ctrl = None
    if first is not None:
        g_ctrl = best - logits.gather(-1, first[..., None])[..., 0]
    return g_blank, g_label, g_ctrl


def widest_gap(g_blank: torch.Tensor, g_label: torch.Tensor, max_tokens: int,
               g_ctrl: Optional[torch.Tensor] = None) -> Tuple[float, Optional[float]]:
    """The least widest gap over the alignments of one utterance's tokens
    (inf where none exists), and the widest control gap along the
    alignment that gives it."""
    gb = g_blank.double().cpu().numpy().copy()
    gl = g_label.double().cpu().numpy()
    t_len, n1 = gb.shape
    if n1 >= max_tokens:                 # a full history takes no label: blank is forced
        gb[:, max_tokens - 1:] = 0.0
    cost = np.full(n1, INF)
    cost[0] = 0.0
    took = np.zeros((t_len, n1), bool)
    for t in range(t_len):
        stay = np.maximum(cost, gb[t])
        move = np.full(n1, INF)
        move[1:] = np.maximum(cost[:-1], gl[t])
        took[t] = move < stay
        cost = np.minimum(stay, move)
    result = float(cost[n1 - 1])
    if g_ctrl is None or result == INF:
        return result, None
    gc = g_ctrl.double().cpu().numpy()
    widest, k = 0.0, n1 - 1
    for t in range(t_len - 1, -1, -1):   # back along the alignment
        k -= int(took[t, k])
        widest = max(widest, float(gc[t, k]))
    return result, widest
