"""Weights carried across from the JAX package.

:func:`from_jax_params` turns the JAX package's parameter tree (nested
dicts of numpy arrays, ``variables["params"]``) into the port's
``state_dict``.  The port's keys are the upstream torch model's, so the JAX
package's ``utils/torch_convert.py::transducer_params`` maps the port's
``encoder``/``decoder``/``joint`` state dicts back to the same tree.

The espnet family's tree (JAX ``models/espnet_variant.py``) maps to the
upstream espnet keys of the port's ``models/espnet_variant.py``, which the
JAX ``utils/torch_convert.py::espnet_transducer_params`` reads back.

Layout rules: torch ``Linear.weight`` is (out, in), the transpose of a flax
kernel; ``qkv``/``out`` have no bias while ``fc1``/``fc2`` do; the FFN's one
LayerNorm (``ff/ln``) is the single ``pos_ff.layer_norm``.  An int8 tree
(JAX ``ops/quant.py::quantize_params``: ``{kernel_q, scale[, bias]}``
leaves) maps to a quantised model's ``weight_q`` (transposed, int8) and
``scale`` (``ops/quant.py::QuantLinear``).

:func:`optimizer_from_jax` maps the optax state that the JAX trainer saves
(``optimizer.msgpack``) into the port's ``Optimizer.state_dict()``: a
momentum or moment tree has the parameter tree's layout, so it goes through
the same key map and transposes.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from transformer_transducer_tpu_torch.models.espnet_variant import (
    _CONV_STACKS, is_espnet_config)

COMPONENTS = ("encoder", "decoder", "joint")


def _t(x) -> torch.Tensor:
    """A float32 tensor that owns its memory (a numpy leaf, possibly a
    read-only view of a checkpoint's bytes, or a bfloat16 tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32, copy=True)
    return torch.from_numpy(np.array(x, dtype=np.float32))   # a writable copy


def _dense(p: Mapping, name: str) -> Dict[str, torch.Tensor]:
    """A flax Dense leaf as the entries of the torch layer ``name``: a
    float ``{kernel (in, out)[, bias]}`` as an ``nn.Linear``'s ``weight``
    (out, in) and ``bias``; an int8 ``{kernel_q (in, out), scale (out,)[,
    bias]}`` (JAX ``QuantDense``) as a ``QuantLinear``'s ``weight_q``
    (out, in), int8, and ``scale``."""
    if "kernel_q" in p:
        w_q = np.array(p["kernel_q"])
        if w_q.dtype != np.int8:
            raise ValueError(f"{name}: an int8 leaf's kernel_q is {w_q.dtype}")
        sd = {name + ".weight_q": torch.from_numpy(w_q).t().contiguous(),
              name + ".scale": _t(p["scale"])}
    else:
        sd = {name + ".weight": _t(p["kernel"]).t().contiguous()}
    if "bias" in p:
        sd[name + ".bias"] = _t(p["bias"])
    return sd


def _layer_state(lp: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    mha = prefix + "MultiHeadAttention."
    attn, ff = lp["attn"], lp["ff"]
    return {
        prefix + "r_emb": _t(lp["r_emb"]),
        prefix + "r_w_bias": _t(lp["r_w_bias"]),
        prefix + "r_bias": _t(lp["r_bias"]),
        **_dense(attn["qkv"], mha + "dec_attn.qkv_net"),
        **_dense(attn["out"], mha + "dec_attn.o_net"),
        mha + "dec_attn.layer_norm.weight": _t(attn["ln"]["scale"]),
        mha + "dec_attn.layer_norm.bias": _t(attn["ln"]["bias"]),
        mha + "pos_ff.layer_norm.weight": _t(ff["ln"]["scale"]),
        mha + "pos_ff.layer_norm.bias": _t(ff["ln"]["bias"]),
        **_dense(ff["fc1"], mha + "pos_ff.CoreNet.0"),
        **_dense(ff["fc2"], mha + "pos_ff.CoreNet.3"),
    }


def _layers(tree: Mapping) -> list:
    names = [k for k in tree if k.startswith("layer_")]
    return sorted(names, key=lambda s: int(s.split("_")[1]))


def _ln(p: Mapping, name: str) -> Dict[str, torch.Tensor]:
    return {name + ".weight": _t(p["scale"]), name + ".bias": _t(p["bias"])}


def _espnet_encoder_state(tree: Mapping) -> Dict[str, torch.Tensor]:
    """An espnet encoder subtree (JAX ``EspnetTransformerEncoder``) as the
    port's state dict, upstream espnet's keys: the inverse of the JAX
    ``utils/torch_convert.py::espnet_encoder_params``.  A flax conv
    kernel (KH, KW, I, O) is torch's (O, I, KH, KW); conv ``i`` of the
    stack is ``embed.conv.{2i}`` (a ReLU between each)."""
    sd: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(_layers(tree)):
        lp, p = tree[name], f"encoders.{i}."
        sa = lp["self_attn"]
        for proj in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            sd.update(_dense(sa[proj], p + "self_attn." + proj))
        sd[p + "self_attn.pos_bias_u"] = _t(sa["pos_bias_u"])
        sd[p + "self_attn.pos_bias_v"] = _t(sa["pos_bias_v"])
        sd.update(_dense(lp["feed_forward"]["w_1"], p + "feed_forward.w_1"))
        sd.update(_dense(lp["feed_forward"]["w_2"], p + "feed_forward.w_2"))
        sd.update(_ln(lp["norm1"], p + "norm1"))
        sd.update(_ln(lp["norm2"], p + "norm2"))
    sd.update(_ln(tree["after_norm"], "after_norm"))
    if "embed" in tree:
        sd["embed.0.weight"] = _t(tree["embed"]["embedding"])
    elif "input_proj" in tree:
        sd.update(_dense(tree["input_proj"], "embed.0"))
        sd.update(_ln(tree["input_norm"], "embed.1"))
    elif "subsample" in tree:
        sub = tree["subsample"]
        convs = sorted((k for k in sub if k.startswith("conv_")),
                       key=lambda s: int(s.split("_")[1]))
        for ci, name in enumerate(convs):
            sd[f"embed.conv.{2 * ci}.weight"] = \
                _t(sub[name]["kernel"]).permute(3, 2, 0, 1).contiguous()
            sd[f"embed.conv.{2 * ci}.bias"] = _t(sub[name]["bias"])
        sd.update(_dense(sub["out"], "embed.out.0"))
    return sd


def component_state(comp: str, tree: Mapping) -> Dict[str, torch.Tensor]:
    """One component's subtree (``encoder``, ``decoder`` or ``joint``) as
    that module's ``state_dict`` (keys without the component's prefix).
    The family is told by the subtree: an espnet encoder has
    ``after_norm``, an espnet joint ``lin_enc``."""
    sd: Dict[str, torch.Tensor] = {}
    if comp in ("encoder", "decoder") and "after_norm" in tree:
        sd.update(_espnet_encoder_state(tree))
    elif comp == "joint" and "lin_enc" in tree:
        for name in ("lin_enc", "lin_dec", "lin_out"):
            sd.update(_dense(tree[name], name))
    elif comp in ("encoder", "decoder"):
        for i, name in enumerate(_layers(tree)):
            sd.update(_layer_state(tree[name], f"layers.{i}."))
        if comp == "decoder":
            sd["dec_embedding.weight"] = _t(tree["embedding"]["embedding"])
    elif comp == "joint":
        sd.update(_dense(tree["forward_layer"], "forward_layer"))
        if "project_bias" in tree:     # tied projection: the weight is the embedding
            sd["project_bias"] = _t(tree["project_bias"])
        else:
            sd.update(_dense(tree["project_layer"], "project_layer"))
    else:
        raise ValueError(f"unknown component {comp!r}; expected one of {COMPONENTS}")
    return sd


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (``variables["params"]`` or ``variables``) -> the
    port's :class:`~models.transducer.Transducer` ``state_dict``."""
    tree = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    for comp in COMPONENTS:
        for key, value in component_state(comp, tree[comp]).items():
            sd[f"{comp}.{key}"] = value
    return sd


def _aligned(tree: Mapping, names: Sequence[str], what: str) -> List[torch.Tensor]:
    """A parameter-shaped tree as tensors in the order of ``names``."""
    try:
        sd = from_jax_params(tree)
    except (KeyError, TypeError) as e:
        raise ValueError(f"the optimizer's {what} tree is not laid out like "
                         f"the parameters: {e!r}") from e
    if set(sd) != set(names):
        raise ValueError(f"the optimizer's {what} tree holds {len(sd)} leaves, "
                         f"the model {len(names)} parameters; they differ in "
                         f"{sorted(set(sd) ^ set(names))[:4]}")
    return [sd[n] for n in names]


def _count(x) -> int:
    return int(np.asarray(x))


def optimizer_from_jax(tree: Mapping, names: Sequence[str]) -> dict:
    """The JAX trainer's optax state (``training/optim.py``: ``chain(
    clip_by_global_norm, inject_hyperparams(chain(decay, trace | adam |
    adadelta, scale)))``, the clip absent without ``max_grad_norm``,
    optionally inside ``MultiSteps``) as the port's
    ``Optimizer.state_dict()``, the moments aligned with the parameters
    ``names`` (``model.named_parameters()`` order).  A state of another
    layout raises ``ValueError``."""
    mini_step, acc = 0, None
    if "inner_opt_state" in tree:              # optax MultiSteps
        mini_step = _count(tree["mini_step"])
        acc = _aligned(tree["acc_grads"], names, "accumulated gradients")
        tree = tree["inner_opt_state"]
    if "hyperparams" not in tree:              # the clip's chain: ({}, inject)
        if not (set(tree) == {"0", "1"} and tree["0"] == {}):
            raise ValueError(f"not an optax state of the JAX trainer's "
                             f"optimizer: keys {sorted(tree)}")
        tree = tree["1"]
    try:
        inner = tree["inner_state"]
        lr = float(np.asarray(tree["hyperparams"]["learning_rate"]))
        count = _count(tree["count"])
        middle = inner["1"]
    except KeyError as e:
        raise ValueError(f"not an inject_hyperparams state: missing {e}") from e
    keys = set(middle)
    if keys == {"trace"}:
        kind, state = "sgd", {"trace": _aligned(middle["trace"], names, "trace")}
    elif keys == {"count", "mu", "nu"}:
        kind = "adam"
        state = {k: _aligned(middle[k], names, k) for k in ("mu", "nu")}
    elif keys == {"e_g", "e_x"}:
        kind = "adadelta"
        state = {k: _aligned(middle[k], names, k) for k in ("e_g", "e_x")}
    elif not keys:
        kind, state = "sgd", {}                # sgd without momentum
    else:
        raise ValueError(f"an optimizer state with {sorted(keys)} has no "
                         "counterpart in the port (sgd trace, adam mu/nu, "
                         "adadelta e_g/e_x)")
    if acc is not None:
        state["acc"] = acc
    return {"kind": kind, "count": count, "mini_step": mini_step, "lr": lr,
            "last_lr": lr, "state": state}


def random_jax_params(model_cfg, seed: int = 0) -> Dict:
    """Seeded random weights for a ``model:`` block, as a numpy tree in the
    JAX package's layout: dense kernels N(0, 1/fan_in) with zero biases,
    LayerNorms at identity, position tables and embedding N(0, 1) (the
    JAX package's initializers for them).  An espnet-schema block (with
    ``model.mask``) gives the espnet family's tree: conv kernels N(0,
    1/fan_in) too, and ``pos_bias_u``/``pos_bias_v`` Xavier-uniform."""
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

    if is_espnet_config(model_cfg):
        return _random_espnet(model_cfg, normal, dense, ln, rng)
    enc, dec, v = model_cfg.enc, model_cfg.dec, model_cfg.vocab_size
    decoder = stack(dec)
    decoder["embedding"] = {"embedding": normal(v, dec.d_model)}
    return {"encoder": stack(enc), "decoder": decoder,
            "joint": {"forward_layer": dense(enc.d_model + dec.d_model,
                                             model_cfg.joint.inner_size),
                      "project_layer": dense(model_cfg.joint.inner_size, v)}}


def _random_espnet(model_cfg, normal, dense, ln, rng) -> Dict:
    """``random_jax_params``'s espnet tree (JAX ``build_espnet_transducer``'s
    ``init`` layout)."""

    def encoder(blk, input_layer):
        d, h = blk.output_size, blk.attention_heads
        bound = (6.0 / (h + d // h)) ** 0.5          # Xavier-uniform of (h, dk)
        out = {f"layer_{i}": {
            "self_attn": {**{n: dense(d, d) for n in
                             ("linear_q", "linear_k", "linear_v", "linear_out")},
                          "linear_pos": dense(d, d, bias=False),
                          **{n: rng.uniform(-bound, bound, (h, d // h)).astype(np.float32)
                             for n in ("pos_bias_u", "pos_bias_v")}},
            "feed_forward": {"w_1": dense(d, blk.linear_units),
                             "w_2": dense(blk.linear_units, d)},
            "norm1": ln(d), "norm2": ln(d)} for i in range(blk.num_blocks)}
        out["after_norm"] = ln(d)
        if input_layer == "embed":
            out["embed"] = {"embedding": normal(blk.input_size, d)}
        elif input_layer == "linear":
            out["input_proj"] = dense(blk.input_size, d)
            out["input_norm"] = ln(d)
        elif input_layer in _CONV_STACKS:
            sub, c_in, f = {}, 1, blk.input_size
            for ci, (k, s) in enumerate(_CONV_STACKS[input_layer]):
                sub[f"conv_{ci}"] = {"kernel": normal(k, k, c_in, d, std=(k * k * c_in) ** -0.5),
                                     "bias": np.zeros(d, np.float32)}
                c_in, f = d, (f - k) // s + 1
            sub["out"] = dense(d * f, d)
            out["subsample"] = sub
        return out

    j = model_cfg.joint
    return {"encoder": encoder(model_cfg.enc, model_cfg.enc.input_layer),
            "decoder": encoder(model_cfg.dec, model_cfg.dec.input_layer or "embed"),
            "joint": {"lin_enc": dense(model_cfg.enc.output_size, j.joint_space_size),
                      "lin_dec": dense(model_cfg.dec.output_size, j.joint_space_size,
                                       bias=False),
                      "lin_out": dense(j.joint_space_size, j.vocab_size)}}
