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

Pipeline parallelism (a mesh with a pipe axis and a model that
``parallel/sharding.py::pipe_model`` split, :func:`make_pipelined_train_step`):
each data rank's rows (``shard_batch``, contiguous) are cut into
``pipe_micro`` microbatches (default ``2 * n_pipe``) and run through the
stages on JAX's GPipe schedule (``parallel/pipeline.py``).  Stage 0 takes
the features and SpecAugment; every stage takes the lengths (with
``data.on_device_features`` from the sample counts, ``ops/features.py::
feature_lengths``); the last stage runs the label encoder, the joint and
the loss, once, on the whole of its rows.  The gradients of the leaves
every stage holds (the label encoder, the joint, the espnet input layer
and ``after_norm``; zero on the stages that did not use them) and the loss
are summed over the pipe group in one all-reduce, exact but for the sign
of a zero; then come the data mean, the whole model's norm and the nan
guard, whose decision is the pipe group's.  JAX's microbatches are
contiguous rows of the global batch split over the data axis, so its data
ranks take other rows than the port's; only the rounding of the mean can
tell the two apart.

Sequence parallelism (a mesh with a seq axis, JAX's ``:125-172``): every
seq rank of a data index takes the same rows and SpecAugment stripes;
the audio encoder runs time-sharded with halo exchange
(``parallel/sequence.py``: the native family's pinned-window banded
encoder of ``sp_window`` rows, the espnet family's exact banded encoder),
and :func:`~parallel.sequence.gather_seq` gives every seq rank the whole
encoding, on which it runs the label encoder, the joint and the loss.  The
gradients of the leaves whose forward on a rank saw only its rows (the
encoder's layers, and the espnet input layer, whose output each rank
slices) are summed over the seq group in one all-reduce; the others (the
label encoder, the joint, espnet's ``after_norm``) are already whole on
every seq rank.  Then come the data mean, the whole model's norm and the
update, as above; the loss is every seq rank's alike.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from transformer_transducer_tpu_torch.ops.features import extract_batch_padded, feature_lengths
from transformer_transducer_tpu_torch.ops.rnnt_loss import rnnt_loss_fused
from transformer_transducer_tpu_torch.ops.rnnt_loss_pruned import rnnt_loss_pruned
from transformer_transducer_tpu_torch.ops.specaug import spec_augment
from transformer_transducer_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_mean_, gather_rows, shard_batch, sum_over_pipe_, sum_over_seq_)
from transformer_transducer_tpu_torch.parallel.pipeline import (
    Pipeline, broadcast_from_last, is_espnet)
from transformer_transducer_tpu_torch.parallel.sequence import (
    encode_banded_sp, encode_banded_sp_espnet)
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
    # microbatches of the pipeline schedule on a mesh with a pipe axis
    # (0: 2 * n_pipe); the bubble is (n_pipe - 1) / (pipe_micro + n_pipe - 1)
    pipe_micro: int = 0
    # the pinned window of the native family's sequence-parallel encoder on
    # a mesh with a seq axis (0: parallel/sequence.py::pinned_window_len)
    sp_window: int = 0


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


def frame_lengths(batch: Dict[str, torch.Tensor], frontend: Optional[Tuple]):
    """``(frames, lengths)`` of a batch's features without computing them:
    the padded frame count and the ``(B,)`` lengths :func:`featurize`
    gives."""
    if frontend is None:
        return batch["inputs"].shape[1], batch["inputs_length"]
    max_frames, factor = frontend[4], frontend[3]
    return max_frames, feature_lengths(batch["inputs_length"], max_frames, factor)


def states_loss(model, cfg: TrainStepConfig, enc, dec, batch, t_len,
                reduction: str = "mean") -> torch.Tensor:
    """The fused or, with ``loss_pruned_range``, the pruned loss of the
    encoder and label states."""
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
        return states_loss(model, cfg, enc, dec, batch, t_len, reduction)
    return loss_fn


def make_seq_loss_fn(model, cfg: TrainStepConfig, mesh: Mesh,
                     generator: Optional[torch.Generator] = None,
                     reduction: str = "mean") -> Callable:
    """:func:`make_loss_fn`'s ``loss_fn`` with the audio encoder sharded
    over the mesh's seq group (``parallel/sequence.py``; ``generator``:
    the encoder layers' dropout seeds, required in train mode).  The
    native family must train banded (JAX's check)."""
    espnet = is_espnet(model)
    if not espnet and model.band is None:
        raise ValueError("sequence parallelism needs banded training "
                         "(--banded / model.enc.left_context+right_context)")
    window = cfg.sp_window or None

    def loss_fn(batch: Dict[str, torch.Tensor], gen: Optional[torch.Generator],
                train: bool = True) -> torch.Tensor:
        inputs, t_len = featurize(batch, cfg.frontend)
        if train and cfg.specaug:
            inputs = spec_augment(gen, inputs, cfg.max_mask_time,
                                  cfg.max_mask_frequency, cfg.mask_num)
        dropout = generator if train else None
        if espnet:
            enc, _ = encode_banded_sp_espnet(model, inputs, t_len, mesh, window, dropout)
            t_len = model.encoded_lengths(t_len, inputs.shape[1])
        else:
            enc = encode_banded_sp(model, inputs, mesh, *model.band, window, dropout)
        dec = model.encode_labels(batch["targets"], batch["targets_length"])
        return states_loss(model, cfg, enc, dec, batch, t_len, reduction)
    return loss_fn


def seq_summed(model, params) -> list:
    """For each of ``params``, whether its gradient is summed over the seq
    group: the audio encoder's leaves, but espnet's ``after_norm``."""
    keep = {id(p) for p in model.encoder.parameters()}
    if is_espnet(model):
        keep -= {id(p) for p in model.encoder.after_norm.parameters()}
    return [id(p) in keep for p in params]


def pipelined_loss(model, cfg: TrainStepConfig, mesh: Mesh, n_micro: int,
                   batch: Dict[str, torch.Tensor], gen: Optional[torch.Generator],
                   dropout: Optional[torch.Generator], train: bool,
                   reduction: str = "mean"):
    """This stage's part of the loss through the pipeline: ``(pipe, enc,
    loss)``, the loss and the encoder output (a leaf) on the last stage
    (None on the others).  Stage 0 featurizes and, in training,
    SpecAugments; the others take the lengths alone."""
    inputs = None
    if mesh.first_stage:
        inputs, t_len = featurize(batch, cfg.frontend)
        t_in = inputs.shape[1]
        if train and cfg.specaug:
            inputs = spec_augment(gen, inputs, cfg.max_mask_time,
                                  cfg.max_mask_frequency, cfg.mask_num)
    else:
        t_in, t_len = frame_lengths(batch, cfg.frontend)
    espnet = is_espnet(model)
    pipe = Pipeline(model, mesh, n_micro, dropout)
    enc = pipe.forward(inputs, batch["targets"].shape[0], t_in,
                       lengths=t_len if espnet else None,
                       band=None if espnet else model.band)
    if not mesh.last_stage:
        return pipe, None, None
    dec = model.encode_labels(batch["targets"], batch["targets_length"])
    if espnet:
        t_len = model.encoded_lengths(t_len, t_in)
    return pipe, enc, states_loss(model, cfg, enc, dec, batch, t_len, reduction)


def make_train_step(model, optimizer: Optimizer,
                    cfg: Optional[TrainStepConfig] = None,
                    mesh: Optional[Mesh] = None,
                    generator: Optional[torch.Generator] = None) -> Callable:
    """``step(batch, gen) -> metrics``: one forward, backward and optimizer
    update of ``model`` in place.  ``metrics["grad_norm"]`` is the norm of
    the raw, unclipped gradients.  With a data ``mesh`` of several ranks
    ``batch`` is this rank's shard (``parallel/mesh.py::shard_batch``) and
    the gradients and the loss are the data ranks' means.  A mesh with a
    pipe axis trains through :func:`make_pipelined_train_step`
    (``generator``: its dropout generator); a mesh with a seq axis through
    :func:`make_seq_loss_fn` (``generator``: the encoder layers' dropout
    seeds; default, one seeded by the data index) and the seq group's sum of
    the encoder's gradients."""
    cfg = cfg or TrainStepConfig()
    if mesh is not None and mesh.pipelined:
        return make_pipelined_train_step(model, optimizer, cfg, mesh,
                                         cfg.pipe_micro or 2 * mesh.n_pipe, generator)
    summed = None
    if mesh is not None and mesh.sequence_parallel:
        if generator is None:
            generator = torch.Generator().manual_seed(mesh.data_rank)
        loss_fn = make_seq_loss_fn(model, cfg, mesh, generator)
        summed = seq_summed(model, optimizer.params)
    else:
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
        if summed is not None:
            # the leaves whose forward saw only this rank's frames
            sum_over_seq_([g for g, s in zip(grads, summed) if s], mesh)
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


def make_pipelined_train_step(model, optimizer: Optimizer, cfg: TrainStepConfig,
                              mesh: Mesh, n_micro: int,
                              generator: Optional[torch.Generator] = None) -> Callable:
    """``step(batch, gen) -> metrics`` through the encoder's stages (see
    the module's docstring): ``batch`` is this data rank's rows, cut into
    ``n_micro`` microbatches.  ``generator`` draws the stages' dropout
    seeds (default: one seeded by the data index).  A mesh of one stage
    runs the same microbatches one by one in one process."""
    if mesh.pipelined and optimizer.pipe is None:
        raise ValueError("a pipelined step needs a model split by "
                         "parallel/sharding.py::pipe_model and its optimizer's pipe plan")
    if generator is None:
        generator = torch.Generator().manual_seed(mesh.data_rank)
    shapes = optimizer.pipe[1] if optimizer.pipe is not None else None

    def step(batch: Dict[str, torch.Tensor], gen: Optional[torch.Generator]):
        model.train()
        for p in optimizer.params:
            p.grad = None
        pipe, enc, loss = pipelined_loss(model, cfg, mesh, n_micro, batch, gen,
                                         generator, train=True)
        if loss is not None:
            loss.backward()
            pipe.backward(enc.grad)
            loss = loss.detach().clone()
        else:
            pipe.backward()
            loss = torch.zeros((), device=batch["targets"].device)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in optimizer.params]
        # the leaves every stage holds, and the loss: summed over the pipe
        # group (zero where a stage did not use them)
        if shapes is not None:
            sum_over_pipe_([g for g, shape in zip(grads, shapes) if shape is None] + [loss],
                           mesh)
        all_reduce_mean_([*grads, loss], mesh)
        grad_norm = global_norm(grads, pipe=optimizer.pipe)
        metrics = {"loss": loss, "grad_norm": grad_norm}
        if cfg.nan_guard:
            bad = (~(torch.isfinite(loss) & torch.isfinite(grad_norm))).float()
            if mesh.pipelined:
                dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=mesh.pipe_group)
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
    ``batch`` (which they divide) and every rank gets all B losses; with a
    pipe axis the encoder runs through the stages and the last stage's
    losses go to every stage."""
    cfg = dataclasses.replace(cfg or TrainStepConfig(), loss_pruned_range=None)
    if mesh is not None and mesh.sequence_parallel:
        loss_fn = make_seq_loss_fn(model, cfg, mesh, reduction="none")
    else:
        loss_fn = make_loss_fn(model, cfg, reduction="none")

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        if mesh is None or not (mesh.parallel or mesh.pipelined):
            return loss_fn(batch, None, train=False)
        mine = shard_batch(batch, mesh)
        if not mesh.pipelined:
            return gather_rows(loss_fn(mine, None, train=False), mesh)
        rows = mine["targets"].shape[0]
        pipe, _, losses = pipelined_loss(model, cfg, mesh, cfg.pipe_micro or 2 * mesh.n_pipe,
                                         mine, None, None, train=False, reduction="none")
        losses = broadcast_from_last(losses, (rows,), torch.float32, pipe.device, mesh)
        return gather_rows(losses, mesh)

    return eval_step
