#!/usr/bin/env python3
"""Training entry point on the card (port of the root ``train.py``).

    python -m transformer_transducer_tpu_torch.apps.train \\
        -config configs/joint_streaming.yaml -log train.log \\
        -mode retrain|continue [--flash | --banded] [--pruned-range N]
        [--bf16] [--remat] [--augment] [--profile DIR] [--device cpu]

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
"""

from __future__ import annotations

import argparse

# flags of the JAX entry point whose paths come in later slices of the port
_LATER = {
    "n_model": "tensor parallelism (--n_model)",
    "n_data": "data parallelism (--n_data)",
    "n_pipe": "pipeline parallelism (--n_pipe)",
    "pipe_micro": "pipeline parallelism (--pipe-micro)",
    "n_seq": "sequence parallelism (--n_seq)",
    "zero": "ZeRO-1 optimizer sharding (--zero)",
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
    ap.add_argument("--zero", action="store_true", default=None)
    ap.add_argument("--pruned-range", type=int, default=None, metavar="N",
                    help="pruned transducer loss with a width-N label band "
                    "(same as --set training.loss_pruned_range=N)")
    for flag in ("--n_model", "--n_data", "--n_pipe", "--pipe-micro", "--n_seq"):
        ap.add_argument(flag, type=int, default=None)
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
    trainer = Trainer(cfg, mode=args.mode, log_file=args.log, flash=args.flash,
                      banded=args.banded, device=args.device,
                      compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                      remat=args.remat)
    trainer.logger.info("device: %s", trainer.device)
    trainer.fit(epochs=args.epochs, augment=args.augment, profile_dir=args.profile)
    return trainer


if __name__ == "__main__":
    main()
