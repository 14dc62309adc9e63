#!/usr/bin/env python3
"""Training entry point on the card (port of the root ``train.py``).

    python -m transformer_transducer_tpu_torch.apps.train \\
        -config configs/joint_streaming.yaml -log train.log \\
        -mode retrain|continue [--flash | --banded] [--device cpu]

``--flash`` trains the unmasked encoder through the flash rel-attention
kernels (forward and backward), ``--banded`` under the streaming band
through the banded kernels; with neither, the dense attention path.  The
RNN-T lattice sweeps run on their kernels in every mode.  Checkpoints,
logs and decode dumps go to ``egs/<data.name>/<training.save_model>/``.
"""

from __future__ import annotations

import argparse

# flags of the JAX entry point whose paths come in later slices of the port
_LATER = {
    "bf16": "bfloat16 training (--bf16)",
    "remat": "encoder rematerialisation (--remat)",
    "augment": "waveform augmentation (ops/augment.py, --augment)",
    "pruned_range": "the pruned loss (ops/rnnt_loss_pruned.py, --pruned-range)",
    "n_model": "tensor parallelism (--n_model)",
    "n_data": "data parallelism (--n_data)",
    "n_pipe": "pipeline parallelism (--n_pipe)",
    "pipe_micro": "pipeline parallelism (--pipe-micro)",
    "n_seq": "sequence parallelism (--n_seq)",
    "zero": "ZeRO-1 optimizer sharding (--zero)",
    "profile": "the profiled epoch (--profile)",
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
    for flag in ("--bf16", "--remat", "--augment", "--zero"):
        ap.add_argument(flag, action="store_true", default=None)
    for flag in ("--pruned-range", "--n_model", "--n_data", "--n_pipe",
                 "--pipe-micro", "--n_seq"):
        ap.add_argument(flag, type=int, default=None)
    ap.add_argument("--profile", default=None, metavar="DIR")
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
    if args.nan_guard:
        cfg.override("training.nan_guard", True)

    trainer = Trainer(cfg, mode=args.mode, log_file=args.log, flash=args.flash,
                      banded=args.banded, device=args.device)
    trainer.logger.info("device: %s", trainer.device)
    trainer.fit(epochs=args.epochs)
    return trainer


if __name__ == "__main__":
    main()
