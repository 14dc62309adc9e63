"""The plain training step: frontend, SpecAugment, the model with dropout,
the mean RNN-T loss, and SGD with momentum after clipping by the global
norm (the reference's ``train.py``: ``clip_grad_norm_(200)``, then
``optimizer.step()``).

SpecAugment (``tt/utils.py``): one set of stripes for the whole batch,
frequency first, then time; ``mask_num`` stripes each, a stripe's width
``floor(U[0, max))`` and its start ``floor(U[0, 1) * (length - width +
1))``, drawn from the generator the caller passes.  Dropout draws from
PyTorch's default generator of the device, site by site in the model's
order (``benchmark/reference/model.py``).  So the caller that seeds both as
the run seeded them gets the run's masks.

The clip follows the clip-by-global-norm rule: the gradients are scaled by
``max_norm / norm`` where ``norm >= max_norm``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.reference import features as F
from benchmark.reference import model as M
from benchmark.reference.rnnt import batch_loss, batch_loss_pruned

JOINT = ["joint.forward_layer.weight", "joint.forward_layer.bias",
         "joint.project_layer.weight", "joint.project_layer.bias"]


def _stripes(gen: torch.Generator, length: int, max_width: int, num: int) -> torch.Tensor:
    widths = (torch.rand(num, generator=gen) * max_width).long()
    starts = (torch.rand(num, generator=gen) * torch.clamp(length - widths + 1, min=1)).long()
    pos = torch.arange(length)[None, :]
    return ((pos >= starts[:, None]) & (pos < (starts + widths)[:, None])).any(0)


def spec_augment(gen: torch.Generator, x: torch.Tensor, max_time: int = 5,
                 max_freq: int = 5, num: int = 10) -> torch.Tensor:
    freq = _stripes(gen, x.shape[2], max_freq, num).to(x.device)
    x = x.masked_fill(freq[None, None, :], 0.0)
    time = _stripes(gen, x.shape[1], max_time, num).to(x.device)
    return x.masked_fill(time[None, :, None], 0.0)


class Batch:
    """A batch as the reference sees it: the raw int16 waves and labels."""

    def __init__(self, waves: List[np.ndarray], labels: List[np.ndarray], max_labels: int):
        self.waves, self.labels = waves, labels
        self.targets = np.zeros((len(labels), max_labels), np.int64)
        for i, y in enumerate(labels):
            self.targets[i, :len(y)] = y


def loss_and_grads(w: Dict[str, torch.Tensor], cfg: Dict, batch: Batch,
                   gen: torch.Generator, dropout_p: float, band: Optional[Tuple[int, int]],
                   specaug: bool = True, pruned: Optional[Tuple[int, float]] = None):
    """The mean loss of ``batch`` and the gradient of every leaf of ``w``;
    ``pruned=(s_range, simple_scale)`` takes the pruned loss.  With it the
    bands' starts come third (else None)."""
    data, model = cfg["data"], cfg["model"]
    max_frames, factor = data["max_input_length"], data["subsample"]
    dev = next(iter(w.values())).device
    feats = F.features(batch.waves, "eps", max_frames, data["left_context_width"],
                       data["right_context_width"], factor, dev, data["feature_dim"])
    if specaug:
        feats = spec_augment(gen, feats)
    t_len = [F.frames(len(x), max_frames, factor) for x in batch.waves]
    u_len = [len(y) for y in batch.labels]
    targets = torch.as_tensor(batch.targets, device=dev)
    drop = (lambda x: torch.nn.functional.dropout(x, dropout_p, True)) if dropout_p else None
    for x in w.values():
        x.requires_grad_(True)
    enc = M.encode_audio(feats, w, model["enc"], band, drop)
    dec = M.encode_labels(torch.nn.functional.pad(targets, (1, 0)), w, model["dec"], drop)
    starts = None
    if pruned is None:
        loss, d_enc, d_dec, grads = batch_loss(enc.detach(), dec.detach(), targets, t_len,
                                               u_len, w, JOINT)
    else:
        loss, d_enc, d_dec, grads, starts = batch_loss_pruned(
            enc.detach(), dec.detach(), targets, t_len, u_len, w, JOINT, *pruned)
    rest = [n for n in w if n not in grads]
    for n, g in zip(rest, torch.autograd.grad([enc, dec], [w[n] for n in rest],
                                              [d_enc, d_dec], allow_unused=True)):
        grads[n] = torch.zeros_like(w[n]) if g is None else g
    for x in w.values():
        x.requires_grad_(False)
    return loss, grads, starts


@torch.no_grad()
def sgd_step(w: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             trace: Dict[str, torch.Tensor], lr: float, momentum: float,
             max_norm: float) -> Dict[str, torch.Tensor]:
    """Clip, then ``trace = momentum * trace + g`` and ``w -= lr * trace``;
    returns the clipped gradients."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    scale = 1.0 if norm < max_norm else float(max_norm / norm)
    clipped = {n: g * scale for n, g in grads.items()}
    for n, g in clipped.items():
        trace[n] = trace[n] * momentum + g if n in trace else g.clone()
        w[n] -= lr * trace[n]
    return clipped
