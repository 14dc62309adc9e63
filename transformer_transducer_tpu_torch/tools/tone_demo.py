"""The held-out tone corpus, its configs, and the learning run (port of the
repo-root ``tools/tone_demo.py``).

Each label symbol is a sine tone at a distinct frequency (10 classes, 0.2 s
a symbol, 2-6 symbols an utterance, a noise floor), so audio -> label is a
mapping a model must learn; train and dev are disjoint random sequences of
the same language.  The waves and CSVs are bit-equal to the JAX tool's at
the same seed, so the port's learning runs train on the corpus the JAX
records (``artifacts/tone_small``, ``artifacts/tpu_tone_demo``) trained on.

    python -m transformer_transducer_tpu_torch.tools.tone_demo --out DIR \
        [--n-train 1024] [--n-dev 64] [--seed 0] [--geometry aishell|small]

writes ``DIR/{vocab.txt,train.csv,dev.csv,test.csv,wav/}`` and
``DIR/config.yaml`` (the geometry's config, ``_config``), and prints the
paths as one JSON line.  Train on it with ``apps/train.py -config
DIR/config.yaml``, or with a recorded config and ``--set data.vocab=...
--set data.train=... --set data.dev=... --set data.test=...``.

With ``--epochs N`` the tool runs the learning run itself, as the JAX tool's
``main`` does: the corpus goes to ``DIR/corpus`` and the config to
``DIR/config.yaml``, the port's training entry point runs as a subprocess
from ``DIR`` with the production flags (``--bf16 --nan-guard
--steps-per-call K --epochs N``, and ``--device`` passed through), then
``DIR/summary.json`` gets the JAX tool's keys (first and last train loss,
the dev CER curve, the final and best dev CER), ``metrics.jsonl`` and
``train.log`` are copied beside it, the waves are removed, and the last
line printed is ``{"final_dev_cer": ..., "best_dev_cer": ...}``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import subprocess
import sys

import numpy as np

from transformer_transducer_tpu_torch.data.wav import write_wave
from transformer_transducer_tpu_torch.utils.config import Config, dump_config
from transformer_transducer_tpu_torch.utils.vocab import Vocabulary

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SYMS = list("abcdefghij")  # 10 tone classes
SR = 16000
TONE_LEN = 3200  # 0.2 s per symbol


def _write_corpus(root, n_train=1024, n_dev=64, seed=0):
    """Held-out tone corpus: train and dev are disjoint random sequences
    drawn from the same 10-tone language (2-6 symbols per utterance).
    Returns ``(vocab_path, {"train": csv, "dev": csv, "test": csv})``."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    vocab = Vocabulary.from_symbols(SYMS + ["<unk>"])
    vocab_path = os.path.join(root, "vocab.txt")
    vocab.save(vocab_path)
    freqs = {s: 300.0 + 420.0 * i for i, s in enumerate(SYMS)}

    def tone(sym):
        t = np.arange(TONE_LEN) / SR
        return np.sin(2 * np.pi * freqs[sym] * t) * 8000.0

    def split(name, n):
        rows = []
        for i in range(n):
            label = "".join(rng.choice(SYMS, size=rng.randint(2, 7)))
            wav = np.concatenate([tone(s) for s in label])
            wav += rng.randn(len(wav)) * 100.0
            path = os.path.join(root, "wav", f"{name}_{i}.wav")
            write_wave(path, wav.astype(np.int16), SR)
            rows.append((path, label))
        p = os.path.join(root, f"{name}.csv")
        with open(p, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["file_path", "label"])
            w.writerows(rows)
        return p

    return vocab_path, {s: split(s, n) for s, n in
                        [("train", n_train), ("dev", n_dev), ("test", n_dev)]}


def _config(vocab_path, csvs, geometry="aishell"):
    """``configs/aishell.yaml`` geometry (d_model 512, 4-layer encoder,
    joint 1024) with the vocabulary head resized to the tone alphabet and
    lengths fit to the corpus (<= 6 tones = ~44 stacked frames), trained by
    a warmup-hold-decay adam; ``geometry="small"`` is the d64 control."""
    if geometry == "small":
        d, n_head, d_inner, n_layer, joint = 64, 2, 128, 2, 64
        dropout, lr = 0.0, 2e-3
    else:
        d, n_head, d_inner, n_layer, joint = 512, 8, 1024, 4, 1024
        # 2e-3 (the d64 recipe) bounces at d512; 1e-3 descends
        dropout, lr = 0.0, 1e-3
    return Config({
        "data": {
            "name": "tone_demo", "vocab": vocab_path,
            "left_context_width": 3, "right_context_width": 0,
            "feature_dim": d // 4, "subsample": 3,  # stacked 4x = d_model
            "max_input_length": 48, "max_target_length": 8,
            "batch_size": 16, "shuffle": True,
            "train": csvs["train"], "dev": csvs["dev"], "test": csvs["test"],
        },
        "model": {
            "type": "transducer",
            "enc": {"max_input_length": 48, "n_head": n_head, "d_model": d,
                    "d_head": d // n_head, "d_inner": d_inner,
                    "n_layer": n_layer,
                    "left_context": 10, "right_context": 2},
            "dec": {"max_target_length": 8, "n_head": n_head, "d_model": d,
                    "d_head": d // n_head, "d_inner": d_inner, "n_layer": 1},
            "joint": {"input_size": 2 * d, "inner_size": joint},
            "vocab_size": 12, "dropout": dropout,
        },
        "training": {
            "exp_name": "tone_demo", "eval_or_not": True, "seed": 1,
            "epochs": 60, "specaug": False,
            # adam at d512 post-LN: the reference's clip of 200 admits
            # gradient spikes that collapse training to blanks; 5.0 damps them
            "max_grad_norm": 5.0,
            "visualization": True, "show_interval": 16,
            "save_model": "aishell_geo",
        },
        # a short hot phase, then an anneal to 1e-4
        "optim": {"type": "adam", "lr": lr, "schedule": "step_decay",
                  "warmup_steps": 200, "hold_steps": 400,
                  "final_step": 1500, "init_lr": 1e-4, "min_lr": 1e-4,
                  "decay_ratio": 1.0, "weight_decay": 0,
                  "begin_to_adjust_lr": 10_000},
    })


def train(out: str, epochs: int, steps_per_call: int = 8, geometry: str = "aishell",
          n_train: int = 1024, n_dev: int = 64, seed: int = 0, device=None) -> dict:
    """The learning run of the JAX tool's ``main`` through the port's
    training entry point; returns the summary it writes."""
    out = os.path.abspath(out)
    os.makedirs(out, exist_ok=True)
    vocab_path, csvs = _write_corpus(os.path.join(out, "corpus"), n_train, n_dev, seed)
    cfg_path = os.path.join(out, "config.yaml")
    dump_config(_config(vocab_path, csvs, geometry=geometry), cfg_path)
    flags = ["--bf16", "--nan-guard", "--steps-per-call", str(steps_per_call)]
    cmd = [sys.executable, "-m", "transformer_transducer_tpu_torch.apps.train",
           "-config", cfg_path, *flags, "--epochs", str(epochs)]
    if device is not None:
        cmd += ["--device", str(device)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    rc = subprocess.call(cmd, cwd=out, env=env)
    if rc != 0:
        raise SystemExit(rc)

    exp = os.path.join(out, "egs", "tone_demo", "aishell_geo")
    cers, losses = [], []
    with open(os.path.join(exp, "metrics.jsonl")) as fh:
        for line in fh:
            row = json.loads(line)
            if row.get("tag") == "cer":
                cers.append((row["step"], row["value"]))
            elif row.get("tag") == "train_loss":
                losses.append((row["step"], row["value"]))
    summary = {
        "geometry": ("configs/aishell.yaml (d_model 512, 4-layer enc, joint 1024), "
                     "vocab head 12" if geometry == "aishell"
                     else "small control (d_model 64, 2-layer enc)"),
        "corpus": f"10-class held-out tone corpus, {n_train} train / {n_dev} dev",
        "flags": " ".join(flags),
        "first_train_loss": losses[0][1] if losses else None,
        "last_train_loss": losses[-1][1] if losses else None,
        "dev_cer_curve": cers,
        "final_dev_cer": cers[-1][1] if cers else None,
        "best_dev_cer": min(v for _, v in cers) if cers else None,
    }
    with open(os.path.join(out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    for name in ("metrics.jsonl", "train.log"):
        shutil.copy(os.path.join(exp, name), os.path.join(out, name))
    shutil.rmtree(os.path.join(out, "corpus", "wav"), ignore_errors=True)
    print(json.dumps({"final_dev_cer": summary["final_dev_cer"],
                      "best_dev_cer": summary["best_dev_cer"]}))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-train", type=int, default=1024)
    ap.add_argument("--n-dev", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--geometry", default="aishell", choices=["aishell", "small"])
    ap.add_argument("--epochs", type=int, default=None,
                    help="run the learning run for N epochs (else write the "
                    "corpus and config only)")
    ap.add_argument("--steps-per-call", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="the training's torch device (default cuda; cpu to run there)")
    args = ap.parse_args(argv)
    if args.epochs is not None:
        return train(args.out, args.epochs, args.steps_per_call, args.geometry,
                     args.n_train, args.n_dev, args.seed, args.device)
    out = os.path.abspath(args.out)
    vocab_path, csvs = _write_corpus(out, args.n_train, args.n_dev, args.seed)
    cfg_path = os.path.join(out, "config.yaml")
    dump_config(_config(vocab_path, csvs, args.geometry), cfg_path)
    paths = {"vocab": vocab_path, **csvs, "config": cfg_path}
    print(json.dumps(paths))
    return paths


if __name__ == "__main__":
    main()
