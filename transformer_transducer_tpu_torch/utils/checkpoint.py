"""Split checkpoints (port of ``utils/checkpoint.py``): the port's own
format, and the JAX package's, read.

The reference saves one ``torch.save`` dict per epoch with the split state
dicts ``{encoder, decoder, joint, optimizer, epoch, step}``
(``tt/utils.py:80-91``), and its loaders can pull the encoder or decoder
alone (``train.py:196-212``).  A port checkpoint is a directory holding that
dict as ``model.pt`` (plus ``lr``, and for mid-epoch ``step_*`` checkpoints
``mid_epoch``, ``batches_done`` and the random generators' states) and a
``meta.json`` with the scalar fields, so finding the newest checkpoint reads
no weights.

A JAX checkpoint is a directory with one ``flax.serialization`` msgpack
file a component (``{encoder,decoder,joint}.msgpack``), optionally
``optimizer.msgpack`` (the optax state) and ``meta.json``; a partial one
(``save_partial_checkpoint``) lists its components in ``meta["components"]``.
An int8-baked checkpoint of either format (``meta["quant"] == "int8"``)
holds the quantised projections (``utils/convert.py``,
``ops/quant.py::QuantLinear``) and loads into a quantised model.
:func:`load_checkpoint` and :func:`load_component` read both formats into
the same dict, through ``utils/flax_msgpack.py`` and ``utils/convert.py``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Sequence

import torch

from transformer_transducer_tpu_torch.utils import convert, flax_msgpack

COMPONENTS = convert.COMPONENTS
MODEL_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.msgpack"


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


def is_jax_checkpoint(path: str) -> bool:
    """Whether ``path`` is a checkpoint directory of the JAX package (one
    msgpack file a component)."""
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, f"{comp}.msgpack")) for comp in COMPONENTS)


def _jax_meta(path: str) -> Dict[str, Any]:
    meta_path = os.path.join(path, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
    check_quant(meta, path)
    return meta


def check_quant(meta: Dict[str, Any], path: str) -> None:
    """A checkpoint is float (no ``quant`` in its meta) or int8-baked
    (``quant: "int8"``, written by the JAX package's or the port's
    ``tools/quantize_checkpoint.py``); any other marker raises."""
    if meta.get("quant") not in (None, "int8"):
        raise ValueError(f"{path}: meta quant={meta['quant']!r}; a checkpoint is "
                         "float or int8-baked (quant 'int8')")


def _jax_component(path: str, comp: str, device=None) -> Dict[str, torch.Tensor]:
    file = os.path.join(path, f"{comp}.msgpack")
    if not os.path.exists(file):
        raise FileNotFoundError(f"JAX checkpoint {path} has no {comp}.msgpack")
    state = convert.component_state(comp, flax_msgpack.read_file(file))
    return {k: v.to(device) for k, v in state.items()} if device is not None else state


def _load_jax_checkpoint(path: str, device=None,
                        param_names: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """A JAX checkpoint directory as the dict :func:`load_checkpoint`
    returns: each component as a state dict, the fields of
    ``meta.json``, and under ``optimizer`` the optax state in the port's
    ``Optimizer.state_dict()`` layout when ``param_names`` (the model's
    ``named_parameters()`` order) is given and ``optimizer.msgpack`` exists
    (else None).  A step checkpoint's JAX random key stays under ``rng`` as
    a list; the port cannot use it."""
    state: Dict[str, Any] = dict(_jax_meta(path))
    for comp in COMPONENTS:
        state[comp] = _jax_component(path, comp, device)
    state["optimizer"] = None
    opt_path = os.path.join(path, OPTIMIZER_FILE)
    if param_names is not None and os.path.exists(opt_path):
        state["optimizer"] = convert.optimizer_from_jax(
            flax_msgpack.read_file(opt_path), list(param_names))
    return state


def load_checkpoint(path: str, device=None,
                    param_names: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """The checkpoint dict of a directory written by :func:`save_checkpoint`
    (or of its ``model.pt`` given directly), tensors on ``device``; of a
    JAX checkpoint directory: its components, the fields of ``meta.json``
    and, with ``param_names``, its optimizer state (see
    :func:`_load_jax_checkpoint`)."""
    if is_jax_checkpoint(path):
        return _load_jax_checkpoint(path, device, param_names)
    if os.path.isdir(path):
        path = os.path.join(path, MODEL_FILE)
    state = torch.load(path, map_location=device, weights_only=True)
    check_quant(state, path)
    return state


def load_component(path: str, comp: str, device=None) -> Dict[str, torch.Tensor]:
    """One component's state dict (``encoder``, ``decoder`` or ``joint``),
    from either format, a JAX partial checkpoint included."""
    if is_jax_checkpoint(path):
        _jax_meta(path)
        return _jax_component(path, comp, device)
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
