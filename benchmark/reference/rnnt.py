"""The plain RNN-T loss (Graves 2012), its gradient by autograd.

``alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u], alpha[t, u-1] +
label[t, u-1])`` from ``alpha[0, 0] = 0``, and the loss ``-(alpha[T-1, U] +
blank[T-1, U])``, over each utterance's true ``T`` frames and ``U`` labels;
the recursion walks the anti-diagonals ``t + u``, all utterances at once.

:func:`batch_loss` computes the joint one utterance at a time at its true
lattice, so the (T, U + 1, V) logits of one utterance are the largest
tensor, and returns the mean loss's gradient for the encoder and label
states and the joint's weights.

:func:`batch_loss_pruned` is the pruned loss of the program's
``--pruned`` training: the linearized joint ``A[t] + L[u]`` (the joint
without its tanh) gives a simple lattice, whose loss is added at
``simple_scale`` and whose occupancy posteriors place a band of
``s_range`` label positions on each frame (:func:`band_starts`); the real
joint's lattice, restricted to the paths that stay inside the bands, gives
the main loss.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference.model import joint_logits

NEG = -1e30


def lattice_nll(blank: torch.Tensor, label: torch.Tensor, t_len: List[int],
                u_len: List[int]) -> torch.Tensor:
    """(B, T, U1) log-probs of the blank and of the next label -> (B,)
    negative log-likelihoods over each row's ``t_len`` x ``u_len + 1``
    lattice."""
    b, t_max, u1 = blank.shape
    dev = blank.device
    u = torch.arange(u1, device=dev)
    rows = torch.arange(b, device=dev)
    diag = torch.full((b, u1), NEG, device=dev, dtype=blank.dtype)
    diag = torch.where(u == 0, torch.zeros_like(diag), diag)
    diagonals = [diag]
    for d in range(1, t_max + u1 - 1):
        t = d - u                                         # this diagonal's frames
        ok = (t >= 0) & (t < t_max)
        tc = t.clamp(0, t_max - 1)
        from_blank = torch.where((t >= 1) & ok,
                                 diag + blank[:, (t - 1).clamp(0, t_max - 1), u], NEG)
        prev = torch.cat([torch.full_like(diag[:, :1], NEG), diag[:, :-1]], 1)
        from_label = torch.where((u >= 1) & ok,
                                 prev + label[:, tc, (u - 1).clamp(min=0)], NEG)
        diag = torch.logaddexp(from_blank, from_label)
        diag = torch.where(ok, diag, torch.full_like(diag, NEG))
        diagonals.append(diag)
    alpha = torch.stack(diagonals, 1)                    # (B, D, U1)
    tl = torch.as_tensor(t_len, device=dev)
    ul = torch.as_tensor(u_len, device=dev)
    return -(alpha[rows, tl - 1 + ul, ul] + blank[rows, tl - 1, ul])


def lattice_logprobs(enc: torch.Tensor, dec: torch.Tensor, labels: torch.Tensor,
                     w: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """One utterance's (T, U1) log-probs of the blank and of each next
    label from its (T, D) and (U1, D) states and its (U1 - 1,) labels."""
    lp = torch.log_softmax(joint_logits(enc[:, None, :], dec[None, :, :], w), -1)
    nxt = torch.cat([labels, labels.new_zeros(1)])
    return lp[..., 0], lp.gather(-1, nxt[None, :, None].expand(lp.shape[0], -1, 1))[..., 0]


def batch_loss(enc: torch.Tensor, dec: torch.Tensor, targets: torch.Tensor,
               t_len: List[int], u_len: List[int], w: Dict, joint_names: List[str]):
    """The mean loss of a batch and its gradients: ``(loss, d_enc, d_dec,
    {name: d_weight})`` for the joint's weights ``joint_names`` (which
    require gradients).

    ``enc`` (B, T, D) and ``dec`` (B, U1, D) are taken as constants; each
    utterance's log-probs are computed without a graph, the lattice's
    gradient by autograd, and then each utterance's joint again with a
    graph to carry that gradient back."""
    b = enc.shape[0]
    t_max, u_max = max(t_len), max(u_len) + 1
    blank = torch.full((b, t_max, u_max), NEG, device=enc.device)
    label = torch.full((b, t_max, u_max), NEG, device=enc.device)
    with torch.no_grad():
        for i in range(b):
            tb, ub = t_len[i], u_len[i]
            pb, pl = lattice_logprobs(enc[i, :tb], dec[i, :ub + 1], targets[i, :ub], w)
            blank[i, :tb, :ub + 1], label[i, :tb, :ub + 1] = pb, pl
    blank.requires_grad_(True)
    label.requires_grad_(True)
    loss = lattice_nll(blank, label, t_len, u_len).mean()
    g_blank, g_label = torch.autograd.grad(loss, (blank, label))
    enc_c = enc.detach().requires_grad_(True)
    dec_c = dec.detach().requires_grad_(True)
    inputs = [enc_c, dec_c] + [w[n] for n in joint_names]
    acc = [torch.zeros_like(x) for x in inputs]
    for i in range(b):
        tb, ub = t_len[i], u_len[i]
        pb, pl = lattice_logprobs(enc_c[i, :tb], dec_c[i, :ub + 1], targets[i, :ub], w)
        part = (pb * g_blank[i, :tb, :ub + 1]).sum() + (pl * g_label[i, :tb, :ub + 1]).sum()
        for a, g in zip(acc, torch.autograd.grad(part, inputs)):
            a += g
    return loss.detach(), acc[0], acc[1], dict(zip(joint_names, acc[2:]))


def simple_logprobs(enc: torch.Tensor, dec: torch.Tensor, labels: torch.Tensor,
                    w: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """One utterance's (T, U1) log-probs of the blank and of each next label
    under the linearized joint: ``A[t] + L[u]`` with ``A = enc W1e W2`` and
    ``L = (dec W1d + b1) W2 + b2``, normalised over the vocabulary."""
    w1, w2 = w["joint.forward_layer.weight"], w["joint.project_layer.weight"]
    d = enc.shape[-1]
    a = (enc @ w1[:, :d].t()) @ w2.t()
    lab = (dec @ w1[:, d:].t() + w["joint.forward_layer.bias"]) @ w2.t() \
        + w["joint.project_layer.bias"]
    lp = torch.log_softmax(a[:, None, :] + lab[None, :, :], -1)
    nxt = torch.cat([labels, labels.new_zeros(1)])
    return lp[..., 0], lp.gather(-1, nxt[None, :, None].expand(lp.shape[0], -1, 1))[..., 0]


def band_starts(occ: torch.Tensor, t_len: int, u_len: int, s_range: int) -> List[int]:
    """The first label position of each frame's band, from one utterance's
    (T, U1) occupancy posteriors: the frame's occupancy-weighted mean
    position less ``(s_range - 1) / 2``, rounded half to even; kept so that
    the band can still climb to ``u_len`` by the last frame at ``s_range -
    1`` a frame; then made non-decreasing from 0, by at most ``s_range -
    1`` a frame."""
    u_hi = max(u_len - (s_range - 1), 0)
    pos = torch.arange(occ.shape[1], dtype=occ.dtype, device=occ.device)
    tot = occ[:t_len].sum(-1)
    centre = (occ[:t_len] * pos).sum(-1) / torch.clamp(tot, min=1e-6)
    raw = torch.round(centre - (s_range - 1) / 2.0).long().tolist()
    starts = [0]
    for t in range(1, t_len):
        least = max(u_hi - (t_len - 1 - t) * (s_range - 1), 0)
        want = min(max(raw[t], least, 0), u_hi)
        starts.append(min(max(want, starts[-1]), starts[-1] + s_range - 1))
    return starts


def band_only(blank: torch.Tensor, label: torch.Tensor, starts: List[int],
              s_range: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One utterance's (T, U1) log-probs with every edge that leaves the
    bands set to ``NEG``: a blank stays in its frame's band and the next
    frame's (the last frame's ends the lattice), a label moves within its
    frame's band."""
    t_len, u1 = blank.shape
    u = torch.arange(u1, device=blank.device)
    lo = torch.as_tensor(starts, device=blank.device)[:, None]
    inside = (u >= lo) & (u < lo + s_range)
    blank_ok = inside.clone()
    blank_ok[:-1] &= inside[1:]
    label_ok = inside & torch.cat([inside[:, 1:], torch.zeros_like(inside[:, :1])], 1)
    return (torch.where(blank_ok, blank, torch.full_like(blank, NEG)),
            torch.where(label_ok, label, torch.full_like(label, NEG)))


def batch_loss_pruned(enc: torch.Tensor, dec: torch.Tensor, targets: torch.Tensor,
                      t_len: List[int], u_len: List[int], w: Dict, joint_names: List[str],
                      s_range: int, simple_scale: float):
    """:func:`batch_loss` for the pruned loss: the mean over the batch of
    each utterance's banded loss plus ``simple_scale`` times its simple
    loss.  The bands come from the simple lattice without a gradient."""
    b = enc.shape[0]
    t_max, u_max = max(t_len), max(u_len) + 1
    grids = [torch.full((b, t_max, u_max), NEG, device=enc.device) for _ in range(4)]
    s_blank, s_label, blank, label = grids
    with torch.no_grad():
        for i in range(b):
            tb, ub = t_len[i], u_len[i]
            pb, pl = simple_logprobs(enc[i, :tb], dec[i, :ub + 1], targets[i, :ub], w)
            s_blank[i, :tb, :ub + 1], s_label[i, :tb, :ub + 1] = pb, pl
    for g in grids:
        g.requires_grad_(True)
    d_blank, d_label = torch.autograd.grad(lattice_nll(s_blank, s_label, t_len, u_len).sum(),
                                           (s_blank, s_label))
    occ = -(d_blank + d_label)
    starts = []
    with torch.no_grad():
        for i in range(b):
            tb, ub = t_len[i], u_len[i]
            starts.append(band_starts(occ[i, :tb, :ub + 1], tb, ub, s_range))
            pb, pl = lattice_logprobs(enc[i, :tb], dec[i, :ub + 1], targets[i, :ub], w)
            blank[i, :tb, :ub + 1], label[i, :tb, :ub + 1] = band_only(pb, pl, starts[i],
                                                                        s_range)
    loss = (lattice_nll(blank, label, t_len, u_len)
            + simple_scale * lattice_nll(s_blank, s_label, t_len, u_len)).mean()
    g_grids = torch.autograd.grad(loss, grids)
    enc_c = enc.detach().requires_grad_(True)
    dec_c = dec.detach().requires_grad_(True)
    inputs = [enc_c, dec_c] + [w[n] for n in joint_names]
    acc = [torch.zeros_like(x) for x in inputs]
    for i in range(b):
        tb, ub = t_len[i], u_len[i]
        cut = lambda g: g[i, :tb, :ub + 1]
        sb, sl = simple_logprobs(enc_c[i, :tb], dec_c[i, :ub + 1], targets[i, :ub], w)
        pb, pl = lattice_logprobs(enc_c[i, :tb], dec_c[i, :ub + 1], targets[i, :ub], w)
        part = sum((x * cut(g)).sum() for x, g in zip((sb, sl, pb, pl), g_grids))
        for a, g in zip(acc, torch.autograd.grad(part, inputs)):
            a += g
    return loss.detach(), acc[0], acc[1], dict(zip(joint_names, acc[2:])), starts
