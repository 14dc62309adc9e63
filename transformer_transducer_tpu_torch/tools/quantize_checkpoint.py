"""Bake a float checkpoint to int8 for serving (port of the repo-root
``tools/quantize_checkpoint.py``).

    python -m transformer_transducer_tpu_torch.tools.quantize_checkpoint \\
        <checkpoint> <out_dir> [--device cpu]

``<checkpoint>`` is anything the port loads (``utils/checkpoint.py``): a
port trainer's ``epoch_N`` directory or its ``model.pt``, a flat
``state_dict`` file, or a JAX package checkpoint directory.  ``<out_dir>``
gets a port checkpoint (``model.pt`` + ``meta.json``) with every
projection stored as int8 plus per-channel float32 scales (the W8A8 scheme
of ``ops/quant.py``) and ``meta["quant"] = "int8"``; the optimizer state is
dropped.  ``models/factory.py::load_family`` loads it straight into the
quantised model; its tensors equal those of ``to_quant`` on the float
model, to the bit.  Prints the weights' and the files' sizes in and out.
Runs on the card unless ``--device cpu`` is given; the tensors are moved
to the CPU only to be written.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import torch

from transformer_transducer_tpu_torch.ops.quant import is_projection_weight, quantize_weight
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.device import resolve_device


def quantize_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A float state dict with each projection's ``weight`` replaced by
    ``weight_q`` and ``scale`` (the keys ``ops/quant.py::quantize_modules``
    gives); every other tensor as it was."""
    out = {}
    for key, value in state.items():
        if is_projection_weight(state, key):
            name = key.rpartition(".")[0]
            out[name + ".weight_q"], out[name + ".scale"] = quantize_weight(value)
        else:
            out[key] = value
    return out


def _source_bytes(path: str) -> int:
    """The bytes of the files that hold the weights."""
    if ckpt_lib.is_jax_checkpoint(path):
        return sum(os.path.getsize(os.path.join(path, f"{c}.msgpack"))
                   for c in ckpt_lib.COMPONENTS)
    if os.path.isdir(path):
        path = os.path.join(path, ckpt_lib.MODEL_FILE)
    return os.path.getsize(path)


def _tensor_bytes(states) -> int:
    return sum(v.numel() * v.element_size() for s in states for v in s.values())


def main(argv=None) -> Dict[str, int]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint")
    ap.add_argument("out_dir")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; pass cpu to run there)")
    args = ap.parse_args(argv)

    state = ckpt_lib.load_checkpoint(args.checkpoint, resolve_device(args.device))
    if state.get("quant") == "int8" or any(k.endswith(".weight_q") for k in state):
        raise ValueError(f"{args.checkpoint} is int8-baked already")
    if set(ckpt_lib.COMPONENTS) <= set(state):
        comps = {c: state[c] for c in ckpt_lib.COMPONENTS}
    else:                                   # a flat state_dict file
        comps = {c: {k[len(c) + 1:]: v for k, v in state.items() if k.startswith(c + ".")}
                 for c in ckpt_lib.COMPONENTS}
    meta = {"epoch": int(state.get("epoch", 0)), "step": int(state.get("step", 0)),
            "quant": "int8"}
    out = {c: {k: v.cpu() for k, v in quantize_state(s).items()} for c, s in comps.items()}
    os.makedirs(args.out_dir, exist_ok=True)
    torch.save({**out, "optimizer": None, **meta},
               os.path.join(args.out_dir, ckpt_lib.MODEL_FILE))
    with open(os.path.join(args.out_dir, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    sizes = {"weights_in": _tensor_bytes(comps.values()),
             "weights_out": _tensor_bytes(out.values()),
             "file_in": _source_bytes(args.checkpoint),
             "file_out": os.path.getsize(os.path.join(args.out_dir, ckpt_lib.MODEL_FILE))}
    mib = {k: v / 2 ** 20 for k, v in sizes.items()}
    print(f"quantized {list(comps)} -> {args.out_dir}: weights {mib['weights_in']:.1f} MiB "
          f"-> {mib['weights_out']:.1f} MiB, file {mib['file_in']:.1f} MiB -> "
          f"{mib['file_out']:.1f} MiB")
    return sizes


if __name__ == "__main__":
    main()
