"""The training step on one device (port of ``training/train_step.py``,
both model families).

Reference step (``train.py:31-65``): SpecAugment + forward + RNN-T loss +
grad-clip(200) + optimizer step.  As in the JAX package the joint, the
log-softmax and the lattice run through the fused loss
(``ops/rnnt_loss.rnnt_loss_fused``), or with ``loss_pruned_range`` through
the pruned loss (``ops/rnnt_loss_pruned.rnnt_loss_pruned``), so no
(B,T,U,V) tensor exists, and padding is ignored by the loss through
``t_len``/``u_len``.  The espnet family encodes with the input lengths (its
pad masks), runs the loss over ``encoded_lengths`` and applies its joint's
activation (JAX ``make_loss_fn``).

Data parallelism (``mesh`` from ``parallel/mesh.py``, one process a data
rank): each rank runs the step on its rows of the global batch; the
gradients and the loss are averaged over the data ranks in one all-reduce
before the global norm, the clip and the nan guard, so every rank takes
the same decision and the same update.  The loss is mean-reduced over
equal shards, so the mean of the ranks' losses is the global batch's.
SpecAugment draws one stripe set a batch from the step's generator, which
every rank seeds alike: the stripes are the single-process run's.

Tensor parallelism (a model that ``parallel/sharding.py::shard_model``
narrowed, ``model.tp``): the loss runs the joint's collectives over the
model group, the mean above runs over the data group (each rank averages
its own shards), the global norm is the whole model's
(``training/optim.py::global_norm``) and the nan guard's decision is the
model group's, after the data mean: a non-finite value on any rank of the
grid makes every rank skip.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from transformer_transducer_tpu_torch.ops.features import extract_batch_padded
from transformer_transducer_tpu_torch.ops.rnnt_loss import rnnt_loss_fused
from transformer_transducer_tpu_torch.ops.rnnt_loss_pruned import rnnt_loss_pruned
from transformer_transducer_tpu_torch.ops.specaug import spec_augment
from transformer_transducer_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_mean_, gather_rows, shard_batch)
from transformer_transducer_tpu_torch.parallel.tensor import tensor_parallel
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
    # > 0: the pruned transducer loss (ops/rnnt_loss_pruned.py), the joint
    # evaluated on a width-N band of label positions around the alignment;
    # None/0: the full loss
    loss_pruned_range: Optional[int] = None
    # weight of the linearized-joint NLL in the pruned loss (k2's simple-loss
    # term; keeps the corridor estimate aligned)
    loss_simple_scale: float = 0.25
    # a non-finite loss or gradient norm leaves the parameters and the
    # optimizer state untouched and is reported as metrics["skipped"]
    nan_guard: bool = False
    # data.on_device_features: (n_mels, left, right, factor, max_frames,
    # log_variant); batch["inputs"] holds padded raw waves and
    # batch["inputs_length"] sample counts, featurized on the batch's device
    # (ops/features.py::extract_batch_padded) before SpecAugment.  None: the
    # host features.
    frontend: Optional[Tuple] = None


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy) as tensors on ``device``: float32 inputs
    (int16 raw waves stay int16, half the bytes to copy), int64 lengths and
    targets."""
    out = {}
    for key, value in batch.items():
        x = torch.as_tensor(np.asarray(value))
        if key != "inputs":
            dtype = torch.long
        else:
            dtype = torch.int16 if x.dtype == torch.int16 else torch.float32
        out[key] = x.to(device, dtype)
    return out


def featurize(batch: Dict[str, torch.Tensor], frontend: Optional[Tuple]):
    """``(inputs, inputs_length)`` of a batch: as they are, or with a
    ``frontend`` tuple the features and frame counts of its raw waves."""
    if frontend is None:
        return batch["inputs"], batch["inputs_length"]
    n_mels, left, right, factor, max_frames, variant = frontend
    return extract_batch_padded(batch["inputs"], batch["inputs_length"], max_frames,
                                n_mels=n_mels, left=left, right=right,
                                factor=factor, log_variant=variant)


def make_loss_fn(model, cfg: TrainStepConfig, reduction: str = "mean") -> Callable:
    """``loss_fn(batch, gen, train=True)``: the on-device frontend (with
    ``cfg.frontend``), SpecAugment (training only, from the
    ``torch.Generator`` ``gen``), ``model.encode_for_loss``, then the fused or, with
    ``loss_pruned_range``, the pruned loss.
    The caller sets the model's train/eval mode (dropout)."""

    def loss_fn(batch: Dict[str, torch.Tensor], gen: Optional[torch.Generator],
                train: bool = True) -> torch.Tensor:
        inputs, t_len = featurize(batch, cfg.frontend)
        if train and cfg.specaug:
            inputs = spec_augment(gen, inputs, cfg.max_mask_time,
                                  cfg.max_mask_frequency, cfg.mask_num)
        # an espnet model's pad masks take the lengths, and a conv input
        # layer shortens its output: the loss runs over the lengths it gives
        enc, dec, t_len = model.encode_for_loss(inputs, t_len, batch["targets"],
                                                batch["targets_length"])
        args = (enc, dec, model.joint_params(), batch["targets"],
                t_len, batch["targets_length"])
        kw = dict(chunk_size=cfg.loss_chunk_size, reduction=reduction,
                  remat=cfg.loss_remat and torch.is_grad_enabled(),
                  activation=model.joint_activation,
                  compute_dtype=model.compute_dtype, tp=model.tp)
        if cfg.loss_pruned_range:
            return rnnt_loss_pruned(*args, s_range=int(cfg.loss_pruned_range),
                                    simple_scale=cfg.loss_simple_scale, **kw)
        return rnnt_loss_fused(*args, **kw)
    return loss_fn


def make_train_step(model, optimizer: Optimizer,
                    cfg: Optional[TrainStepConfig] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """``step(batch, gen) -> metrics``: one forward, backward and optimizer
    update of ``model`` in place.  ``metrics["grad_norm"]`` is the norm of
    the raw, unclipped gradients.  With a data ``mesh`` of several ranks
    ``batch`` is this rank's shard (``parallel/mesh.py::shard_batch``) and
    the gradients and the loss are the data ranks' means."""
    cfg = cfg or TrainStepConfig()
    loss_fn = make_loss_fn(model, cfg)
    parallel = mesh is not None and mesh.parallel

    def step(batch: Dict[str, torch.Tensor], gen: Optional[torch.Generator]):
        model.train()
        for p in optimizer.params:
            p.grad = None
        loss = loss_fn(batch, gen, train=True)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in optimizer.params]
        if parallel:
            loss = loss.detach().clone()
            all_reduce_mean_([*grads, loss], mesh)
        grad_norm = global_norm(grads, optimizer.tp)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm}
        if cfg.nan_guard:
            bad = (~(torch.isfinite(loss) & torch.isfinite(grad_norm))).float()
            if tensor_parallel(model.tp):
                dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=model.tp.model_group)
            ok = not bool(bad)
            metrics["skipped"] = int(not ok)
            if not ok:
                return metrics
        optimizer.step(grads)
        return metrics

    return step


def make_eval_loss_step(model, cfg: Optional[TrainStepConfig] = None,
                        mesh: Optional[Mesh] = None) -> Callable:
    """``eval_step(batch) -> (B,)`` per-utterance losses: eval mode, no
    SpecAugment, no gradients.  The exact full NLL even when training is
    pruned: the pruned loss upper-bounds it by a band-dependent margin, which
    would make dev losses incomparable across band widths.  With a data
    ``mesh`` of several ranks each rank takes its rows of the global
    ``batch`` (which they divide) and every rank gets all B losses."""
    cfg = dataclasses.replace(cfg or TrainStepConfig(), loss_pruned_range=None)
    loss_fn = make_loss_fn(model, cfg, reduction="none")

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        if mesh is None or not mesh.parallel:
            return loss_fn(batch, None, train=False)
        return gather_rows(loss_fn(shard_batch(batch, mesh), None, train=False), mesh)

    return eval_step
