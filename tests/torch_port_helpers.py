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


# ---------------------------------------------------------------------------
# The flash kernels' tile algebra (tests/test_torch_port_flash_*_tiles.py)
# ---------------------------------------------------------------------------

def bd_rows(tlen, o):
    """Table row of each offset o, or -1 (o == 1, or outside the table)."""
    row = torch.where(o <= 0, tlen - 1 + o, o - 2)
    return torch.where((o == 1) | (row < 0) | (row >= tlen), -1, row)


def gather_rows(table, rows):
    """table[rows] with zeros where rows == -1; table (T, H, ...)."""
    out = table[rows.clamp(min=0)]
    return out * (rows >= 0).view(-1, *([1] * (out.dim() - 1))).to(out.dtype)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round fp32 to 10 mantissa bits, to nearest with
    ties away from zero, on the bits (the low 13 bits become zero)."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-0x80000000, dtype=torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def tc_product(a: torch.Tensor, b: torch.Tensor, terms: str,
               acc: torch.Tensor = None) -> torch.Tensor:
    """(..., M, K) . (..., K, N) as the kernels' mma.sync.m16n8k8 tiles
    compute it: an fp32 accumulator (``acc``, else zeros) that takes each
    8-deep step's exact products; ``terms`` "3x" adds lo.hi + hi.lo + hi.hi
    of the split operands, "1x" hi.hi."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if terms == "3x" else [(a_hi, b_hi)]
    c = torch.zeros(*torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]), a.shape[-2],
                    b.shape[-1], dtype=torch.float32) if acc is None else acc
    for k in range(0, a.shape[-1], 8):
        for x, y in pairs:
            # products of two TF32 values are exact in fp64; the step's sum
            # enters the fp32 accumulator once
            c = c + (x[..., k:k + 8].double() @ y[..., k:k + 8, :].double()).float()
    return c
