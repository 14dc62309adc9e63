"""Model export for deployment: the inference components as
``torch.export`` programs (port of ``runtime/export.py``).

The reference TorchScript-traces encoder, decoder and joint separately for
Android (``assets/script.py:40-60``); the JAX package serialises them with
``jax.export``.  Here each component is traced by ``torch.export.export``
at fixed batch-1 shapes and written with ``torch.export.save`` as
``<out_dir>/<name>.pt2``, which :func:`load_exported` runs without the
model's Python code.  The flash attention kernels are ``torch.library``
ops (``ops/cuda/flash_rel_attention.py``), so an exported full-context
encoder holds one ``ttx::flash_rel_attention_fwd`` node a layer and, run
on the card, launches kernel 8 there; the loader imports the op
registrations first.  A program runs on the device it was exported on.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from transformer_transducer_tpu_torch.ops.masks import context_mask, look_ahead_mask


class _Component(nn.Module):
    """One of the model's inference methods on a shallow copy of the model
    that holds only the ``children`` it reads, so that its program carries
    those weights alone (as JAX's carries only the constants it uses), and
    its constant mask as a buffer."""

    def __init__(self, model: nn.Module, method: str, children: Tuple[str, ...],
                 mask: Optional[torch.Tensor] = None):
        super().__init__()
        part = copy.copy(model)
        part._modules = {k: v for k, v in model._modules.items() if k in children}
        self.model, self.method = part, method
        self.register_buffer("mask", mask, persistent=False)

    def forward(self, *args: torch.Tensor) -> torch.Tensor:
        fn = getattr(self.model, self.method)
        return fn(*args) if self.method == "joint_logits" else fn(*args, self.mask)


def export_transducer(model: nn.Module, out_dir: str, max_frames: int = 410,
                      max_tokens: int = 43, d_in: int = 512,
                      left_context: Optional[int] = None,
                      right_context: Optional[int] = None) -> Dict[str, str]:
    """Write ``encoder``, ``encoder_streaming`` (only when both contexts
    are given: the encoder under ``context_mask``), ``decoder`` (the label
    encoder under ``look_ahead_mask(max_tokens)``) and ``joint`` (on
    ``(1, d_model)`` states) to ``<out_dir>/{name}.pt2``; returns their
    paths by name.  The model is traced in eval mode with no gradients, on
    example inputs on its own device, and left in the mode it had."""
    os.makedirs(out_dir, exist_ok=True)
    device = next(model.parameters()).device
    paths = {}

    def save(name, component, *args):
        program = torch.export.export(component, args)
        path = os.path.join(out_dir, f"{name}.pt2")
        torch.export.save(program, path)
        paths[name] = path

    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            x = torch.zeros((1, max_frames, d_in), device=device)
            save("encoder", _Component(model, "encode", ("encoder",)), x)
            if left_context is not None and right_context is not None:
                mask = context_mask(max_frames, left_context, right_context, device=device)
                save("encoder_streaming", _Component(model, "encode", ("encoder",), mask), x)
            tokens = torch.zeros((1, max_tokens), dtype=torch.long, device=device)
            save("decoder", _Component(model, "predict", ("decoder",),
                                       look_ahead_mask(max_tokens, device=device)), tokens)
            # a tied joint's output weight is the label embedding
            tied = ("decoder",) if getattr(model, "share_embedding", False) else ()
            # two tensors: one passed twice would trace as one input
            enc, dec = (torch.zeros((1, model_dim(model)), device=device) for _ in "ed")
            save("joint", _Component(model, "joint_logits", ("joint", *tied)), enc, dec)
    finally:
        model.train(training)
    return paths


def model_dim(model: nn.Module) -> int:
    """The encoder's output width, from the joint's input weight: half the
    native concat joint's ``forward_layer`` input, or the espnet joint's
    ``lin_enc`` input (an int8 layer's ``weight_q``)."""
    joint = model.joint

    def in_dim(layer) -> int:
        return (layer.weight_q if hasattr(layer, "weight_q") else layer.weight).shape[1]
    if hasattr(joint, "forward_layer"):
        return in_dim(joint.forward_layer) // 2
    return in_dim(joint.lin_enc)


def load_exported(path: str) -> Callable:
    """A ``.pt2`` program written by :func:`export_transducer`, as a
    callable module (the op registrations imported first)."""
    from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention  # noqa: F401
    return torch.export.load(path).module()
