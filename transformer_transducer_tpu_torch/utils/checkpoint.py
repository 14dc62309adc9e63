"""Split checkpoints (port of ``utils/checkpoint.py``, in the port's own
format).

The reference saves one ``torch.save`` dict per epoch with the split state
dicts ``{encoder, decoder, joint, optimizer, epoch, step}``
(``tt/utils.py:80-91``), and its loaders can pull the encoder or decoder
alone (``train.py:196-212``).  A port checkpoint is a directory holding that
dict as ``model.pt`` (plus ``lr``, and for mid-epoch ``step_*`` checkpoints
``mid_epoch``, ``batches_done`` and the random generators' states) and a
``meta.json`` with the scalar fields, so finding the newest checkpoint reads
no weights.  Reading the JAX package's msgpack checkpoints comes in a later
slice.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

COMPONENTS = ("encoder", "decoder", "joint")
MODEL_FILE = "model.pt"


def save_checkpoint(path: str, model, optimizer=None, epoch: int = 0,
                    step: int = 0, extra: Optional[Dict[str, Any]] = None,
                    rng: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """Write a checkpoint directory; ``extra`` holds JSON scalars (also in
    ``meta.json``), ``rng`` generator states.  Returns ``path``."""
    os.makedirs(path, exist_ok=True)
    meta = {"epoch": int(epoch), "step": int(step), **(extra or {})}
    state = {comp: getattr(model, comp).state_dict() for comp in COMPONENTS}
    state["optimizer"] = None if optimizer is None else optimizer.state_dict()
    state.update(meta)
    if rng is not None:
        state["rng"] = rng
    torch.save(state, os.path.join(path, MODEL_FILE))
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    return path


def load_checkpoint(path: str, device=None) -> Dict[str, Any]:
    """The checkpoint dict of a directory written by :func:`save_checkpoint`
    (or of its ``model.pt`` given directly), tensors on ``device``."""
    if os.path.isdir(path):
        path = os.path.join(path, MODEL_FILE)
    return torch.load(path, map_location=device, weights_only=True)


def load_component(path: str, comp: str, device=None) -> Dict[str, torch.Tensor]:
    """One component's state dict (``encoder``, ``decoder`` or ``joint``)."""
    return load_checkpoint(path, device)[comp]


def latest_checkpoint(exp_dir: str) -> Optional[str]:
    """Newest checkpoint directory under ``exp_dir`` by global step, or None.

    Both ``epoch_*`` and ``step_*`` (mid-epoch) checkpoints count; on a step
    tie the epoch checkpoint wins (it also carries the decayed next-epoch
    learning rate)."""
    if not os.path.isdir(exp_dir):
        return None
    best = None           # (step, is_epoch, path)
    for d in os.listdir(exp_dir):
        if not (d.startswith("epoch_") or d.startswith("step_")):
            continue
        meta_path = os.path.join(exp_dir, d, "meta.json")
        if not os.path.exists(meta_path):
            continue
        with open(meta_path) as fh:
            meta = json.load(fh)
        key = (int(meta.get("step", 0)), d.startswith("epoch_"),
               os.path.join(exp_dir, d))
        if best is None or key > best:
            best = key
    return best[2] if best else None


def prune_step_checkpoints(exp_dir: str, keep: Optional[str] = None) -> None:
    """Delete the ``step_*`` checkpoint directories except ``keep``: they
    are recovery points, not history."""
    if not os.path.isdir(exp_dir):
        return
    for d in os.listdir(exp_dir):
        path = os.path.join(exp_dir, d)
        if d.startswith("step_") and path != keep:
            shutil.rmtree(path, ignore_errors=True)
