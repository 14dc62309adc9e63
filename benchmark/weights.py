"""Seeded weights of a native-family Transformer-Transducer, made on the
device in two large random calls.

Both sides of the comparison take their weights from here: the program
loads the dict into its model (``load_state_dict``, strict), the plain
reference reads it as it is.  The names are the upstream model's
state-dict keys.  Linear weights and biases are uniform in
``±1/sqrt(fan_in)`` (PyTorch's default), the relative-position tables and
the label embedding standard normal (the model's own initialisation), and
LayerNorm weights ``1 ± 0.1`` and biases ``±0.1``, so that no bias is zero.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str, int]]


def _layer(prefix: str, k_len: int, h: int, dh: int, d: int, d_inner: int) -> Spec:
    a = prefix + "MultiHeadAttention."
    return [
        (prefix + "r_emb", (k_len, h, dh), "normal", 0),
        (prefix + "r_w_bias", (h, dh), "normal", 0),
        (prefix + "r_bias", (k_len, h), "normal", 0),
        (a + "dec_attn.qkv_net.weight", (3 * h * dh, d), "uniform", d),
        (a + "dec_attn.o_net.weight", (d, h * dh), "uniform", h * dh),
        (a + "dec_attn.layer_norm.weight", (d,), "ln_weight", 0),
        (a + "dec_attn.layer_norm.bias", (d,), "ln_bias", 0),
        (a + "pos_ff.CoreNet.0.weight", (d_inner, d), "uniform", d),
        (a + "pos_ff.CoreNet.0.bias", (d_inner,), "uniform", d),
        (a + "pos_ff.CoreNet.3.weight", (d, d_inner), "uniform", d_inner),
        (a + "pos_ff.CoreNet.3.bias", (d,), "uniform", d_inner),
        (a + "pos_ff.layer_norm.weight", (d,), "ln_weight", 0),
        (a + "pos_ff.layer_norm.bias", (d,), "ln_bias", 0),
    ]


def spec(model: Dict) -> Spec:
    """(name, shape, kind, fan_in) of every leaf of a ``model:`` block."""
    enc, dec, joint = model["enc"], model["dec"], model["joint"]
    v = model["vocab_size"]
    out: Spec = []
    for i in range(enc["n_layer"]):
        out += _layer(f"encoder.layers.{i}.", enc["max_input_length"], enc["n_head"],
                      enc["d_head"], enc["d_model"], enc["d_inner"])
    out.append(("decoder.dec_embedding.weight", (v, dec["d_model"]), "normal", 0))
    for i in range(dec["n_layer"]):
        out += _layer(f"decoder.layers.{i}.", dec["max_target_length"], dec["n_head"],
                      dec["d_head"], dec["d_model"], dec["d_inner"])
    width = enc["d_model"] + dec["d_model"]
    inner = joint["inner_size"]
    out += [("joint.forward_layer.weight", (inner, width), "uniform", width),
            ("joint.forward_layer.bias", (inner,), "uniform", width),
            ("joint.project_layer.weight", (v, inner), "uniform", inner),
            ("joint.project_layer.bias", (v,), "uniform", inner)]
    return out


def make(leaves: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The leaves as float32 tensors on ``device``, from ``seed``: one normal
    and one uniform draw over all of them, then each leaf's slice scaled."""
    n = sum(torch.Size(shape).numel() for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n, generator=gen, device=device)
    uniform = torch.rand(n, generator=gen, device=device).mul_(2).sub_(1)
    out, at = {}, 0
    for name, shape, kind, fan_in in leaves:
        size = torch.Size(shape).numel()
        if kind == "normal":
            x = normal[at:at + size]
        elif kind == "uniform":
            x = uniform[at:at + size] * fan_in ** -0.5
        elif kind == "ln_weight":
            x = 1 + 0.1 * uniform[at:at + size]
        else:
            x = 0.1 * uniform[at:at + size]
        out[name] = x.reshape(shape).clone()
        at += size
    return out


def gate_blank(w: Dict[str, torch.Tensor], model: Dict, direction: torch.Tensor,
               centre: float, scale: float) -> None:
    """Give a recognising model's blank a decision that follows the audio
    frame, in place.  With random weights the blank's logit moves with the
    label history as much as with the frame, so each emission moves the
    rate: models emit on nearly every frame or on almost none.  Here the
    joint's unit 0 reads the encoder state alone, ``tanh(z / 2)`` with ``z
    = (direction . enc - centre) / scale``, and the blank's row reads that
    unit alone, at 2, with a bias of 0 (``entries/recognize.py`` chooses
    the direction and sets the bias from the plain reference)."""
    d_enc = model["enc"]["d_model"]
    first = w["joint.forward_layer.weight"][0]
    first.zero_()
    first[:d_enc] = direction / (2 * scale)
    w["joint.forward_layer.bias"][0] = -centre / (2 * scale)
    w["joint.project_layer.weight"][0].zero_()
    w["joint.project_layer.weight"][0, 0] = 2.0
    w["joint.project_layer.bias"][0] = 0
