"""Family-dispatching model construction for the apps (port of
``models/factory.py``).

An espnet-schema config carries a ``model.mask`` block; that family is
ported in a later slice, so it raises here.
"""

from __future__ import annotations

import copy

from transformer_transducer_tpu_torch.models.transducer import build_transducer
from transformer_transducer_tpu_torch.ops.quant import quantize_modules
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib


def build_family(cfg, d_in: int, device=None, flash: bool = False):
    """The model of a full config; ``d_in`` is the stacked feature
    dimension, which the native family takes as ``d_model``."""
    if cfg.model.mask is not None:
        raise NotImplementedError(
            "the espnet family (models/espnet_variant.py) is ported in a later "
            "slice of the PyTorch port")
    if d_in != cfg.model.enc.d_model:
        raise ValueError(f"stacked features ({d_in}) must equal enc.d_model "
                         f"({cfg.model.enc.d_model}): the encoder has no input "
                         "projection")
    return build_transducer(cfg.model, flash=flash, device=device)


def load_family(cfg, d_in: int, checkpoint=None, device=None,
                flash: bool = False, int8: bool = False):
    """``build_family`` + optional weights from ``checkpoint``: a checkpoint
    directory the trainer wrote (``utils/checkpoint.py::save_checkpoint``,
    e.g. ``egs/<name>/<save_model>/epoch_19``), its ``model.pt``, a flat
    ``state_dict`` file written with ``torch.save(model.state_dict(), path)``,
    or a checkpoint directory of the JAX package (told apart by its
    ``encoder.msgpack``; the JAX ``train.py``'s ``epoch_*`` and ``step_*``).
    A file is told apart by its keys: a trainer's dict holds the split
    ``encoder``, ``decoder`` and ``joint`` state dicts.

    ``int8``: serve the W8A8 twin (``ops/quant.py``).  As in the JAX
    ``load_family``, a float checkpoint is quantised after loading, and an
    int8-baked one (``meta["quant"] == "int8"``, from either package's
    ``tools/quantize_checkpoint.py``; a flat file by its ``weight_q``
    keys) loads straight into the quantised model, with or without
    ``int8``."""
    model = build_family(cfg, d_in, device=device, flash=flash)
    if checkpoint is not None:
        state = ckpt_lib.load_checkpoint(checkpoint, next(model.parameters()).device)
        split = set(ckpt_lib.COMPONENTS) <= set(state)
        if (state.get("quant") == "int8" if split
                else any(k.endswith(".weight_q") for k in state)):
            quantize_modules(model)
        if split:
            for comp in ckpt_lib.COMPONENTS:
                getattr(model, comp).load_state_dict(state[comp])
        else:
            model.load_state_dict(state)
    if int8 and not model.quant:
        quantize_modules(model)
    return model


def to_quant(model):
    """The int8 serving twin of a float model (JAX ``to_quant``): a copy
    with every projection W8A8 (``ops/quant.py::quantize_modules``); the
    float model is left as it was.  Inference only."""
    return quantize_modules(copy.deepcopy(model))
