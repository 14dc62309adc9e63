"""Convert a reference PyTorch ``.chkpt`` to the port's checkpoint (port of
the repo-root ``tools/convert_checkpoint.py``).

    python -m transformer_transducer_tpu_torch.tools.convert_checkpoint \\
        ref.chkpt out_dir [--espnet] [--device cpu]

The reference saves ``{encoder, decoder, joint, optimizer, epoch, step}``
(``tt/utils.py:80-91``).  The port's ``state_dict`` keys are the
reference's, so the conversion is the layout: each component keeps the
parameters the family's model has (``--espnet``: the tt_espnet family) as
float32, a missing one raises, anything else in the file is left out, and
the optimizer state is dropped, as the JAX tool drops it (a continued run
starts its optimizer moments afresh).  ``out_dir`` gets a port checkpoint
(``model.pt`` + ``meta.json`` with the file's epoch and step) that every app
loads.  The tensors pass through the card unless ``--device cpu`` is
given, and are written from the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, Mapping, Sequence

import torch

from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.device import resolve_device

# the native family: the keys of one rel-position layer (encoder and decoder)
LAYER_KEYS = ("r_emb", "r_w_bias", "r_bias",
              "MultiHeadAttention.dec_attn.qkv_net.weight",
              "MultiHeadAttention.dec_attn.o_net.weight",
              "MultiHeadAttention.dec_attn.layer_norm.weight",
              "MultiHeadAttention.dec_attn.layer_norm.bias",
              "MultiHeadAttention.pos_ff.layer_norm.weight",
              "MultiHeadAttention.pos_ff.layer_norm.bias",
              "MultiHeadAttention.pos_ff.CoreNet.0.weight",
              "MultiHeadAttention.pos_ff.CoreNet.0.bias",
              "MultiHeadAttention.pos_ff.CoreNet.3.weight",
              "MultiHeadAttention.pos_ff.CoreNet.3.bias")
JOINT_KEYS = ("forward_layer.weight", "forward_layer.bias",
              "project_layer.weight", "project_layer.bias")
# the espnet family (ESPnet's TransformerEncoder, for encoder and decoder)
ESPNET_LAYER_KEYS = tuple(
    [f"self_attn.linear_{n}.{p}" for n in ("q", "k", "v", "out") for p in ("weight", "bias")]
    + ["self_attn.linear_pos.weight", "self_attn.pos_bias_u", "self_attn.pos_bias_v"]
    + [f"feed_forward.w_{i}.{p}" for i in (1, 2) for p in ("weight", "bias")]
    + [f"norm{i}.{p}" for i in (1, 2) for p in ("weight", "bias")])
ESPNET_JOINT_KEYS = ("lin_enc.weight", "lin_enc.bias", "lin_dec.weight",
                     "lin_out.weight", "lin_out.bias")


def _n_layers(sd: Mapping[str, torch.Tensor], prefix: str) -> int:
    found = [int(m.group(1)) for k in sd for m in [re.match(prefix + r"\.(\d+)\.", k)] if m]
    if not found:
        raise KeyError(f"no {prefix}.N. keys in the state dict")
    return 1 + max(found)


def _espnet_embed_keys(sd: Mapping[str, torch.Tensor]) -> Sequence[str]:
    """The input layer's keys: a conv subsampling stack, an embedding, or a
    linear projection with its norm (JAX ``espnet_encoder_params``)."""
    if "embed.conv.0.weight" in sd:
        return sorted(k for k in sd if re.fullmatch(r"embed\.conv\.\d+\.(weight|bias)", k)) \
            + ["embed.out.0.weight", "embed.out.0.bias"]
    if "embed.0.weight" in sd and sd["embed.0.weight"].ndim == 2 and "embed.0.bias" not in sd:
        return ["embed.0.weight"]
    if "embed.0.weight" in sd:
        return ["embed.0.weight", "embed.0.bias", "embed.1.weight", "embed.1.bias"]
    return []


def component_keys(comp: str, sd: Mapping[str, torch.Tensor], espnet: bool) -> Sequence[str]:
    """The keys of ``comp``'s parameters in the port's model of the family."""
    if comp == "joint":
        return ESPNET_JOINT_KEYS if espnet else JOINT_KEYS
    if espnet:
        keys = [f"encoders.{i}.{k}" for i in range(_n_layers(sd, "encoders"))
                for k in ESPNET_LAYER_KEYS]
        return keys + ["after_norm.weight", "after_norm.bias"] + list(_espnet_embed_keys(sd))
    keys = [f"layers.{i}.{k}" for i in range(_n_layers(sd, "layers")) for k in LAYER_KEYS]
    return keys + (["dec_embedding.weight"] if comp == "decoder" else [])


def convert(ck: Mapping, espnet: bool = False, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """A reference checkpoint dict -> the port's component state dicts."""
    out = {}
    for comp in ckpt_lib.COMPONENTS:
        sd = ck[comp]
        keys = component_keys(comp, sd, espnet)
        missing = [k for k in keys if k not in sd]
        if missing:
            raise KeyError(f"the {comp} lacks {missing[:4]}{' ...' if len(missing) > 4 else ''}"
                           f" ({'espnet' if espnet else 'native'} family)")
        out[comp] = {k: sd[k].detach().to(device=device, dtype=torch.float32).contiguous()
                     for k in keys}
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("chkpt")
    ap.add_argument("out_dir")
    ap.add_argument("--espnet", action="store_true", help="the source is the tt_espnet family")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; pass cpu to run there)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ck = torch.load(args.chkpt, map_location="cpu", weights_only=True)
    comps = convert(ck, args.espnet, device)
    meta = {"epoch": int(ck.get("epoch", 0)), "step": int(ck.get("step", 0))}
    os.makedirs(args.out_dir, exist_ok=True)
    torch.save({**{c: {k: v.cpu() for k, v in sd.items()} for c, sd in comps.items()},
                "optimizer": None, **meta}, os.path.join(args.out_dir, ckpt_lib.MODEL_FILE))
    with open(os.path.join(args.out_dir, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    print(f"converted {args.chkpt} -> {args.out_dir} (epoch {meta['epoch']}, "
          f"step {meta['step']})")
    return args.out_dir


if __name__ == "__main__":
    main()
