"""Weights carried across from the JAX package.

:func:`from_jax_params` turns the JAX package's parameter tree (nested
dicts of numpy arrays, ``variables["params"]``) into the port's
``state_dict``.  The port's keys are the upstream torch model's, so the JAX
package's ``utils/torch_convert.py::transducer_params`` maps the port's
``encoder``/``decoder``/``joint`` state dicts back to the same tree.

Layout rules: torch ``Linear.weight`` is (out, in), the transpose of a flax
kernel; ``qkv``/``out`` have no bias while ``fc1``/``fc2`` do; the FFN's one
LayerNorm (``ff/ln``) is the single ``pos_ff.layer_norm``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))   # a writable copy


def _layer_state(lp: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    mha = prefix + "MultiHeadAttention."
    attn, ff = lp["attn"], lp["ff"]
    return {
        prefix + "r_emb": _t(lp["r_emb"]),
        prefix + "r_w_bias": _t(lp["r_w_bias"]),
        prefix + "r_bias": _t(lp["r_bias"]),
        mha + "dec_attn.qkv_net.weight": _t(np.asarray(attn["qkv"]["kernel"]).T),
        mha + "dec_attn.o_net.weight": _t(np.asarray(attn["out"]["kernel"]).T),
        mha + "dec_attn.layer_norm.weight": _t(attn["ln"]["scale"]),
        mha + "dec_attn.layer_norm.bias": _t(attn["ln"]["bias"]),
        mha + "pos_ff.layer_norm.weight": _t(ff["ln"]["scale"]),
        mha + "pos_ff.layer_norm.bias": _t(ff["ln"]["bias"]),
        mha + "pos_ff.CoreNet.0.weight": _t(np.asarray(ff["fc1"]["kernel"]).T),
        mha + "pos_ff.CoreNet.0.bias": _t(ff["fc1"]["bias"]),
        mha + "pos_ff.CoreNet.3.weight": _t(np.asarray(ff["fc2"]["kernel"]).T),
        mha + "pos_ff.CoreNet.3.bias": _t(ff["fc2"]["bias"]),
    }


def _layers(tree: Mapping) -> list:
    names = [k for k in tree if k.startswith("layer_")]
    return sorted(names, key=lambda s: int(s.split("_")[1]))


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (``variables["params"]`` or ``variables``) -> the
    port's :class:`~models.transducer.Transducer` ``state_dict``."""
    tree = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    enc, dec, joint = tree["encoder"], tree["decoder"], tree["joint"]
    for i, name in enumerate(_layers(enc)):
        sd.update(_layer_state(enc[name], f"encoder.layers.{i}."))
    sd["decoder.dec_embedding.weight"] = _t(dec["embedding"]["embedding"])
    for i, name in enumerate(_layers(dec)):
        sd.update(_layer_state(dec[name], f"decoder.layers.{i}."))
    sd["joint.forward_layer.weight"] = _t(np.asarray(joint["forward_layer"]["kernel"]).T)
    sd["joint.forward_layer.bias"] = _t(joint["forward_layer"]["bias"])
    if "project_bias" in joint:     # tied projection: the weight is the embedding
        sd["joint.project_bias"] = _t(joint["project_bias"])
    else:
        sd["joint.project_layer.weight"] = _t(np.asarray(joint["project_layer"]["kernel"]).T)
        sd["joint.project_layer.bias"] = _t(joint["project_layer"]["bias"])
    return sd


def random_jax_params(model_cfg, seed: int = 0) -> Dict:
    """Seeded random weights for a ``model:`` block, as a numpy tree in the
    JAX package's layout: dense kernels N(0, 1/fan_in) with zero biases,
    LayerNorms at identity, position tables and embedding N(0, 1) (the
    JAX package's initializers for them)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def dense(n_in, n_out, bias=True):
        p = {"kernel": normal(n_in, n_out, std=n_in ** -0.5)}
        if bias:
            p["bias"] = np.zeros(n_out, np.float32)
        return p

    def ln(d):
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    def stack(c):
        h, dh, d = c.n_head, c.d_head, c.d_model
        k_len = c.max_input_length or c.max_target_length
        return {f"layer_{i}": {
            "r_emb": normal(k_len, h, dh), "r_w_bias": normal(h, dh),
            "r_bias": normal(k_len, h),
            "attn": {"qkv": dense(d, 3 * h * dh, bias=False),
                     "out": dense(h * dh, d, bias=False), "ln": ln(d)},
            "ff": {"ln": ln(d), "fc1": dense(d, c.d_inner),
                   "fc2": dense(c.d_inner, d)},
        } for i in range(c.n_layer)}

    enc, dec, v = model_cfg.enc, model_cfg.dec, model_cfg.vocab_size
    decoder = stack(dec)
    decoder["embedding"] = {"embedding": normal(v, dec.d_model)}
    return {"encoder": stack(enc), "decoder": decoder,
            "joint": {"forward_layer": dense(enc.d_model + dec.d_model,
                                             model_cfg.joint.inner_size),
                      "project_layer": dense(model_cfg.joint.inner_size, v)}}
