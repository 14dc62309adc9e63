"""The casts of bf16 compute over float32 parameters (``--bf16``).

The JAX package computes in ``compute_dtype`` by casting where its modules
cast (``x.astype(cd)`` before a projection, ``.astype(jnp.float32)`` before
a softmax or a residual add) and by its type promotion; torch would round
elsewhere (``F.linear``'s fused bias, a float32 scalar, automatic mixed
precision's own choice of operators).  The helpers here put the roundings
where JAX puts them.  Under float32 compute each one returns its input as it is, so the
float32 path is the path without them, and a float64 rerun of a float32
model (the tests' arbiter) stays float64.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

NEG_INF = torch.finfo(torch.float32).min
# NEG_INF rounded to bf16, as JAX's jnp.asarray(NEG_INF, bfloat16): -inf
# (float32's least value lies beyond bf16's)
NEG_INF_BF16 = float(torch.tensor(NEG_INF).to(torch.bfloat16))


def to_compute(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(compute_dtype)``: a cast under bf16 compute only."""
    return x if compute_dtype == torch.float32 else x.to(compute_dtype)


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(float32)`` of a bf16 tensor; any other as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def neg_inf(dtype: torch.dtype) -> float:
    """The masked score in ``dtype``: ``NEG_INF``, or ``NEG_INF_BF16`` in
    bf16."""
    return NEG_INF_BF16 if dtype == torch.bfloat16 else NEG_INF


@functools.lru_cache(maxsize=None)
def scalar(value: float, dtype: torch.dtype) -> float:
    """A Python constant as it meets a ``dtype`` tensor in JAX: a weakly
    typed scalar takes the tensor's dtype, so beside a bf16 tensor it is
    rounded to bf16 first (torch would keep it in float32)."""
    return float(torch.tensor(value).to(dtype)) if dtype == torch.bfloat16 else value


def dense(layer: nn.Module, x: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``layer(x)`` in ``compute_dtype``.  Under float32 the layer as it is
    (float or int8); under bf16 the product of the bf16-cast input and
    weight, then the bf16 bias in a separate add (flax ``Dense(dtype=...)``;
    ``F.linear``'s fused bias rounds once, not twice)."""
    if compute_dtype == torch.float32:
        return layer(x)
    y = nn.functional.linear(x.to(compute_dtype), layer.weight.to(compute_dtype))
    return y if layer.bias is None else y + layer.bias.to(compute_dtype)
