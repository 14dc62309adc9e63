"""The training step on one device (port of ``training/train_step.py``,
native family, full loss).

Reference step (``train.py:31-65``): SpecAugment + forward + RNN-T loss +
grad-clip(200) + optimizer step.  As in the JAX package the joint, the
log-softmax and the lattice run through the fused loss
(``ops/rnnt_loss.rnnt_loss_fused``), so no (B,T,U,V) tensor exists, and
padding is ignored by the loss through ``t_len``/``u_len``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from transformer_transducer_tpu_torch.ops.rnnt_loss import (
    joint_params, rnnt_loss_fused)
from transformer_transducer_tpu_torch.ops.specaug import spec_augment
from transformer_transducer_tpu_torch.training.optim import Optimizer, global_norm


@dataclasses.dataclass
class TrainStepConfig:
    specaug: bool = True
    max_mask_time: int = 5
    max_mask_frequency: int = 5
    mask_num: int = 10
    loss_chunk_size: int = 16
    # recompute each T-chunk of the joint in the backward instead of keeping
    # its activations (ops/rnnt_loss.fused_grid_logprobs)
    loss_remat: bool = True
    # a non-finite loss or gradient norm leaves the parameters and the
    # optimizer state untouched and is reported as metrics["skipped"]
    nan_guard: bool = False


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy) as tensors on ``device``: float32 inputs,
    int64 lengths and targets."""
    out = {}
    for key, value in batch.items():
        x = torch.as_tensor(np.asarray(value))
        out[key] = x.to(device, torch.float32 if key == "inputs" else torch.long)
    return out


def make_loss_fn(model, cfg: TrainStepConfig, reduction: str = "mean") -> Callable:
    """``loss_fn(batch, gen, train=True)``: SpecAugment (training only, from
    the ``torch.Generator`` ``gen``), ``encode_both``, then the fused loss.
    The caller sets the model's train/eval mode (dropout)."""

    def loss_fn(batch: Dict[str, torch.Tensor], gen: Optional[torch.Generator],
                train: bool = True) -> torch.Tensor:
        inputs = batch["inputs"]
        if train and cfg.specaug:
            inputs = spec_augment(gen, inputs, cfg.max_mask_time,
                                  cfg.max_mask_frequency, cfg.mask_num)
        enc, dec = model.encode_both(inputs, batch["targets"])
        return rnnt_loss_fused(enc, dec, joint_params(model), batch["targets"],
                               batch["inputs_length"], batch["targets_length"],
                               chunk_size=cfg.loss_chunk_size,
                               reduction=reduction,
                               remat=cfg.loss_remat and torch.is_grad_enabled())
    return loss_fn


def make_train_step(model, optimizer: Optimizer,
                    cfg: Optional[TrainStepConfig] = None) -> Callable:
    """``step(batch, gen) -> metrics``: one forward, backward and optimizer
    update of ``model`` in place.  ``metrics["grad_norm"]`` is the norm of
    the raw, unclipped gradients."""
    cfg = cfg or TrainStepConfig()
    loss_fn = make_loss_fn(model, cfg)

    def step(batch: Dict[str, torch.Tensor], gen: Optional[torch.Generator]):
        model.train()
        for p in optimizer.params:
            p.grad = None
        loss = loss_fn(batch, gen, train=True)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in optimizer.params]
        grad_norm = global_norm(grads)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm}
        if cfg.nan_guard:
            ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
            metrics["skipped"] = int(not ok)
            if not ok:
                return metrics
        optimizer.step(grads)
        return metrics

    return step


def make_eval_loss_step(model, cfg: Optional[TrainStepConfig] = None) -> Callable:
    """``eval_step(batch) -> (B,)`` per-utterance losses: eval mode, no
    SpecAugment, no gradients."""
    loss_fn = make_loss_fn(model, cfg or TrainStepConfig(), reduction="none")

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        return loss_fn(batch, None, train=False)

    return eval_step
