#!/usr/bin/env python3
"""Training entry point on the card (port of the root ``train.py``).

    python -m transformer_transducer_tpu_torch.apps.train \\
        -config configs/joint_streaming.yaml -log train.log \\
        -mode retrain|continue [--flash | --banded] [--pruned-range N]
        [--bf16] [--remat] [--augment] [--profile DIR] [--device cpu]
        [--n_data N] [--n_model M | --n_pipe P [--pipe-micro K]] [--zero]

    torchrun --nproc_per_node N*M -m transformer_transducer_tpu_torch.apps.train \
        -config ... --n_data N --n_model M [--zero]
    torchrun --nproc_per_node N*P -m transformer_transducer_tpu_torch.apps.train \
        -config ... --n_data N --n_pipe P [--pipe-micro K] [--zero]

``--flash`` trains the unmasked encoder through the flash rel-attention
kernels (forward and backward), ``--banded`` under the streaming band
through the banded kernels; with neither, the dense attention path.  The
RNN-T lattice sweeps run on their kernels in every mode.  ``--pruned-range
N`` trains the pruned loss (the joint on a width-N label band, with the
logZ and band-sweep kernels); it combines with either attention mode.
``--bf16`` trains with bfloat16 compute over float32 parameters (the model,
both losses and the evaluation cast where the JAX package casts; the
kernels of the banded and dense paths take float32, as JAX feeds them;
with ``--flash`` the flash kernels' bf16 forms take bf16, as JAX's do).
``--remat`` recomputes each encoder layer in the backward.
``--profile DIR`` trains the first epoch under ``torch.profiler`` and
writes TensorBoard's ``*.pt.trace.json`` there (CPU and, on the card, CUDA
activity: the hand-written kernels appear by name).
``--augment`` runs the waveform augmentation chain (``ops/augment.py``) on
the training set; ``--set data.on_device_features=true`` ships raw waves
and runs the log-mel on the card.  ``-mode continue`` also resumes from the
JAX package's checkpoints (``epoch_*`` or ``step_*`` directories with
msgpack files) in the experiment directory or at ``training.load_model``.
Checkpoints, logs and decode dumps go to
``egs/<data.name>/<training.save_model>/``.

An espnet-schema config (``model.mask``) trains the espnet family with the
full or the pruned loss; ``apps/train_esptt.py`` runs this entry point with
``configs/espnet_aishell.yaml`` by default.  ``--flash`` and ``--banded``
select the native family's attention kernels and do not apply to it.

Data parallelism: under ``torchrun`` (or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``) each process joins the
group and takes the card ``LOCAL_RANK`` modulo the cards present; the
backend is NCCL with a card a rank, gloo on the CPU or when several ranks
share a card (``parallel/mesh.py::backend_for``).  ``--n_data N``
(default: the largest divisor of the batch at most the world size) trains
on N data ranks, ``--zero`` (or ``--set parallel.zero=true``) splits the
optimizer's moments over them (ZeRO-1).  ``--n_model M`` shards each
replica over M ranks (tensor parallelism, JAX's ``model`` axis: heads, the
FFN's inner width and the joint's; ``parallel/sharding.py``), on a
``(data, model)`` grid with ``model`` minor; it composes with ``--zero``,
``--flash``, ``--banded``, ``--pruned-range``, ``--bf16`` and ``--remat``,
and its checkpoints hold the whole model.  ``--n_pipe P`` splits the
encoder's layers into P stages (pipeline parallelism, JAX's ``pipe`` axis;
``parallel/pipeline.py``), on a ``(data, pipe)`` grid with ``pipe`` minor,
each step JAX's GPipe schedule over ``--pipe-micro K`` microbatches
(default 2P; or ``--set parallel.n_pipe=P`` / ``parallel.pipe_micro=K``);
it composes with ``--zero``, ``--flash``, ``--banded``, ``--pruned-range``,
``--bf16`` and both families, not with ``--n_model``; ``--remat`` does not
apply inside the stages, and its checkpoints hold the whole model.
``--n_seq`` comes in a later slice and raises.
"""

from __future__ import annotations

import argparse

# flags of the JAX entry point whose paths come in later slices of the port
_LATER = {
    "n_seq": "sequence parallelism (--n_seq)",
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-config", "--config", default="configs/joint_streaming.yaml")
    ap.add_argument("-log", "--log", default="train.log")
    ap.add_argument("-mode", "--mode", default="retrain",
                    choices=["retrain", "continue"])
    ap.add_argument("--flash", action="store_true",
                    help="flash rel-attention kernels for the unmasked encoder")
    ap.add_argument("--banded", action="store_true",
                    help="train the encoder under the streaming band "
                    "(model.enc.left_context/right_context) through the banded "
                    "kernels")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--steps-per-call", type=int, default=None,
                    help="K single steps between step-checkpoint checks (same "
                    "as --set training.steps_per_call=K)")
    ap.add_argument("--nan-guard", action="store_true",
                    help="skip updates whose loss or gradient norm is not "
                    "finite (same as --set training.nan_guard=true)")
    ap.add_argument("--save-steps", type=int, default=None, metavar="N",
                    help="mid-epoch checkpoint every N steps (same as --set "
                    "training.save_every_steps=N); -mode continue resumes there")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override (dotted key)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; pass cpu to run there)")
    ap.add_argument("--augment", action="store_true",
                    help="waveform augmentation chain on the training set")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (parameters stay float32)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the encoder layers in the backward")
    ap.add_argument("--zero", action="store_true", default=None,
                    help="ZeRO-1: split the optimizer's moments over the data "
                    "ranks (same as --set parallel.zero=true)")
    ap.add_argument("--n_data", type=int, default=None,
                    help="data-parallel ranks (default: the largest divisor of "
                    "the batch at most the world size)")
    ap.add_argument("--pruned-range", type=int, default=None, metavar="N",
                    help="pruned transducer loss with a width-N label band "
                    "(same as --set training.loss_pruned_range=N)")
    ap.add_argument("--n_model", type=int, default=1,
                    help="tensor-parallel ranks a replica (JAX's model axis)")
    ap.add_argument("--n_pipe", type=int, default=None,
                    help="pipeline stages of the encoder (JAX's pipe axis; same as "
                    "--set parallel.n_pipe=P)")
    ap.add_argument("--pipe-micro", type=int, default=None,
                    help="microbatches a pipelined step (default 2 * n_pipe; same as "
                    "--set parallel.pipe_micro=K)")
    ap.add_argument("--n_seq", type=int, default=None)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="profile the first epoch (torch.profiler) and write "
                    "TensorBoard's *.pt.trace.json to DIR")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for name, what in _LATER.items():
        if getattr(args, name) is not None:
            raise NotImplementedError(f"{what} is ported in a later slice of "
                                      "the PyTorch port")
    if args.flash and args.banded:
        raise ValueError("pass --flash or --banded, not both")

    from transformer_transducer_tpu_torch.training.trainer import Trainer
    from transformer_transducer_tpu_torch.utils.config import (
        apply_overrides, load_config)

    cfg = load_config(args.config)
    apply_overrides(cfg, args.set)
    if args.steps_per_call:
        cfg.override("training.steps_per_call", args.steps_per_call)
    if args.save_steps:
        cfg.override("training.save_every_steps", args.save_steps)
    if args.pruned_range:
        cfg.override("training.loss_pruned_range", args.pruned_range)
    if args.nan_guard:
        cfg.override("training.nan_guard", True)

    import torch
    from transformer_transducer_tpu_torch.parallel import mesh as mesh_lib
    device = mesh_lib.local_device(args.device)
    mesh_lib.init_distributed(torch.device(device if device is not None else "cuda"))
    trainer = Trainer(cfg, mode=args.mode, log_file=args.log, flash=args.flash,
                      banded=args.banded, device=device,
                      compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                      remat=args.remat, n_data=args.n_data, zero=args.zero,
                      n_model=args.n_model, n_pipe=args.n_pipe,
                      pipe_micro=args.pipe_micro)
    trainer.logger.info("device: %s", trainer.device)
    trainer.fit(epochs=args.epochs, augment=args.augment, profile_dir=args.profile)
    return trainer


if __name__ == "__main__":
    main()
