"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_port_*).

Both packages get the same inputs, made with numpy from a seed, and the same
weights: a JAX ``init`` tree, carried into the port by
``utils/convert.py::from_jax_params``.  Shapes are small: 2 encoder layers,
d_model 64, 4 heads x 16.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from transformer_transducer_tpu.models.transducer import build_transducer as jax_build
from transformer_transducer_tpu.utils.config import Config as JaxConfig
from transformer_transducer_tpu_torch.models.transducer import build_transducer
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.convert import from_jax_params

# fp32 parity tolerances (ROADMAP "Tolerances"): same math, different
# summation order in the two frameworks
TOL = dict(rtol=2e-4, atol=2e-5)

N_MELS = 16          # 16 mels x (1 + 3 + 0) stacked frames = d_model 64
ENC_K_LEN = 120      # T in (120, 150] exercises the front-pad rule


def tiny_model_cfg(vocab: int = 50, enc_layers: int = 2,
                   share_embedding: bool = False) -> dict:
    return {
        "enc": {"n_layer": enc_layers, "max_input_length": ENC_K_LEN,
                "left_context": 10, "right_context": 2, "n_head": 4,
                "d_model": 64, "d_head": 16, "d_inner": 128},
        "dec": {"n_layer": 2, "max_target_length": 42, "n_head": 4,
                "d_model": 64, "d_head": 16, "d_inner": 128},
        "joint": {"inner_size": 64 if share_embedding else 96},
        "vocab_size": vocab,
        "share_embedding": share_embedding,
        "dropout": 0.0,
    }


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def jax_model(model_cfg: dict, flash: bool = False, seed: int = 0):
    """(JAX Transducer, numpy variables) with flax-initialised weights."""
    model = jax_build(JaxConfig(copy.deepcopy(model_cfg)), flash=flash)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 64)),
                           jnp.zeros((1, 4), jnp.int32))
    return model, to_numpy_tree(variables)


def port_model(model_cfg: dict, variables, flash: bool = False):
    """The port's model on the CPU with the JAX weights."""
    model = build_transducer(Config(copy.deepcopy(model_cfg)), flash=flash,
                             device="cpu")
    model.load_state_dict(from_jax_params(variables["params"]))
    return model


def bias_blank(variables, offset: float):
    """Shift the joint's blank logit so only some frames emit."""
    out = copy.deepcopy(variables)
    out["params"]["joint"]["project_layer"]["bias"][0] += offset
    return out


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))
