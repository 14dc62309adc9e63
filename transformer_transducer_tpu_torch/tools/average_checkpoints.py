"""Average the n best epoch checkpoints of an experiment (port of the
repo-root ``tools/average_checkpoints.py``).

    python -m transformer_transducer_tpu_torch.tools.average_checkpoints EXP_DIR \\
        [--nbest 5] [--criterion cer|eval_loss] [--out DIR] [--device cpu]
    python -m transformer_transducer_tpu_torch.tools.average_checkpoints \\
        --checkpoints ep_3 ep_7 [--out DIR] [--device cpu]

The reference vendors ESPnet2's n-best averaging (``espnet2/main_funcs/
average_nbest_models.py:15-90``) without wiring it up.  Epochs are ranked by
a scalar of the trainer's ``metrics.jsonl`` (``cer`` or ``eval_loss``, lower
is better; the last record of an epoch wins), or the checkpoints are named
with ``--checkpoints``.  Each is anything ``utils/checkpoint.py`` reads: the
port's ``epoch_N`` directories (or their ``model.pt``) and the JAX package's
msgpack directories alike.  Floating leaves are summed in float64 and the
mean is stored in the leaf's dtype (float32); integer leaves follow ESPnet's
rule, summed in int64 and floor-divided by n (``average_nbest_models.py:
82-100``).  ``--nbest 1`` gives the best checkpoint's weights to the bit.
The output is a port checkpoint (``model.pt`` + ``meta.json``, no optimizer
state, ``averaged_from`` in the meta) that every app loads.  An int8-baked
checkpoint is refused: average the float ones, then quantise.  The sums run
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.device import resolve_device


def rank_epochs(exp_dir: str, criterion: str) -> List[Tuple[int, float]]:
    """``(epoch, value)`` sorted ascending by the criterion; the last record
    of an epoch wins, as a resumed run rewrites a re-evaluated epoch."""
    path = os.path.join(exp_dir, "metrics.jsonl")
    if not os.path.exists(path):
        raise SystemExit(f"{path} not found: the trainer writes it when "
                         "training.visualization is on; otherwise pass --checkpoints")
    per_epoch: Dict[int, float] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("tag") == criterion:
                per_epoch[int(rec["step"])] = float(rec["value"])
    if not per_epoch:
        raise SystemExit(f"no '{criterion}' records in {path}: train with the "
                         "evaluation on, or pass --checkpoints")
    return sorted(per_epoch.items(), key=lambda kv: kv[1])


def _components(path: str, device) -> Dict[str, Dict[str, torch.Tensor]]:
    state = ckpt_lib.load_checkpoint(path, device)
    if state.get("quant") == "int8" or any(k.endswith(".weight_q") for k in state):
        raise ValueError(f"{path} is int8-baked: average float checkpoints, then "
                         "quantise the average")
    if set(ckpt_lib.COMPONENTS) <= set(state):
        return {c: state[c] for c in ckpt_lib.COMPONENTS}
    return {c: {k[len(c) + 1:]: v for k, v in state.items() if k.startswith(c + ".")}
            for c in ckpt_lib.COMPONENTS}                  # a flat state_dict file


def average_checkpoints(paths: Sequence[str], out: str, device=None) -> str:
    """Leaf-wise average of the checkpoints at ``paths`` into the port
    checkpoint ``out``; returns ``out``."""
    n = len(paths)
    acc, dtypes = None, None
    for p in paths:
        comps = _components(p, device)
        wide = {c: {k: v.to(torch.float64 if v.is_floating_point() else torch.int64)
                    for k, v in sd.items()} for c, sd in comps.items()}
        if acc is None:
            acc = wide
            dtypes = {c: {k: v.dtype for k, v in sd.items()} for c, sd in comps.items()}
            continue
        for c, sd in wide.items():
            if set(sd) != set(acc[c]):
                raise ValueError(f"{p}: the {c} differs in its keys from {paths[0]}'s: "
                                 f"{sorted(set(sd) ^ set(acc[c]))}")
            for k, v in sd.items():
                acc[c][k] += v
    avg = {c: {k: (torch.div(s, n, rounding_mode="floor") if not dtypes[c][k].is_floating_point
                   else s / n).to(dtypes[c][k]).cpu()
               for k, s in sd.items()} for c, sd in acc.items()}
    meta = {"epoch": -1, "step": -1,
            "averaged_from": [os.path.basename(os.path.normpath(p)) for p in paths]}
    os.makedirs(out, exist_ok=True)
    torch.save({**avg, "optimizer": None, **meta}, os.path.join(out, ckpt_lib.MODEL_FILE))
    with open(os.path.join(out, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    return out


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("exp_dir", nargs="?", help="experiment directory with "
                    "metrics.jsonl and epoch_* checkpoints")
    ap.add_argument("--nbest", type=int, default=5)
    ap.add_argument("--criterion", default="cer", choices=["cer", "eval_loss"])
    ap.add_argument("--checkpoints", nargs="+", default=None,
                    help="explicit checkpoint directories (skips the ranking)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; pass cpu to run there)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.checkpoints:
        paths = list(args.checkpoints)
        out = args.out or os.path.join(os.path.dirname(os.path.normpath(paths[0])) or ".",
                                       f"ave_{len(paths)}ckpt")
    else:
        if not args.exp_dir:
            ap.error("need an exp_dir or --checkpoints")
        chosen = rank_epochs(args.exp_dir, args.criterion)[:max(1, args.nbest)]
        paths = [os.path.join(args.exp_dir, f"epoch_{e}") for e, _ in chosen]
        missing = [p for p in paths if not os.path.isdir(p)]
        if missing:
            raise SystemExit(f"missing checkpoint directories: {missing}")
        out = args.out or os.path.join(args.exp_dir, f"ave_{len(paths)}best_{args.criterion}")
        print(f"averaging {len(paths)} best by {args.criterion}: "
              + ", ".join(f"epoch_{e}={v:.4f}" for e, v in chosen))
    average_checkpoints(paths, out, device)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
