"""Family-dispatching model construction for the apps (port of
``models/factory.py``).

The two model families share the CLI surface; a config selects the family:
an espnet-schema config carries a ``model.mask`` block (reference
``config/espnet_aishell.yaml``, ``models/espnet_variant.py``), any other is
the native family (``models/transducer.py``).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from transformer_transducer_tpu_torch.models.espnet_variant import (
    build_espnet_transducer, is_espnet_config)
from transformer_transducer_tpu_torch.models.transducer import build_transducer
from transformer_transducer_tpu_torch.ops.quant import quantize_modules
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib


def build_family(cfg, d_in: Optional[int] = None, device=None,
                 flash: bool = False, banded: bool = False, remat: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
    """The model of a full config, in eval mode.  ``d_in``, if given, is
    the stacked feature dimension, which the native family
    takes as ``d_model`` and an espnet encoder with no input layer as its
    ``output_size``.  ``flash`` and ``banded`` select the native family's
    attention kernels (``build_transducer``), and ``remat`` recomputes its
    encoder layers in the backward; the espnet family has neither kernels
    nor remat and ignores them, as the JAX trainer does.  ``compute_dtype``
    (either family): bf16 compute over float32 parameters, so checkpoints
    are the same either way."""
    model_cfg = cfg.model
    if is_espnet_config(model_cfg):
        enc = model_cfg.enc
        width = enc.output_size if enc.input_layer is None else enc.input_size
        if d_in is not None and d_in != width:
            raise ValueError(f"stacked features ({d_in}) must equal the espnet "
                             f"encoder's input width ({width})")
        return build_espnet_transducer(model_cfg, device=device,
                                       compute_dtype=compute_dtype)
    if d_in is not None and d_in != model_cfg.enc.d_model:
        raise ValueError(f"stacked features ({d_in}) must equal enc.d_model "
                         f"({model_cfg.enc.d_model}): the encoder has no input "
                         "projection")
    return build_transducer(model_cfg, flash=flash, banded=banded, device=device,
                            remat=remat, compute_dtype=compute_dtype)


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

    Either family: the checkpoint's component state dicts carry its
    family's keys (a JAX espnet tree maps through ``utils/convert.py``).

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
