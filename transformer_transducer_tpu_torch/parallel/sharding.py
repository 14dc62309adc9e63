"""ZeRO-1 partition of the optimizer state (port of the ZeRO part of
``parallel/sharding.py``).

Parameters and gradients stay whole on every data rank; each moment (the
SGD trace, Adam's mu and nu, Adadelta's accumulators) is split over the
data ranks on one dimension of its parameter, the ZeRO stage-1 partition
(Rajbhandari et al., arXiv:1910.02054).  The dimension is the JAX rule's
(``zero_param_shardings``): the largest dimension that divides by
``n_data``, the first of equals, read in the JAX layout of the leaf, so a
port slice holds the same elements as the JAX device's shard (a torch
``Linear.weight`` is the transpose of a flax kernel, a ``Conv2d`` weight
flax's (KH, KW, I, O) permuted to (O, I, KH, KW)).  A leaf with no such
dimension stays whole on every rank.

The tensor-parallel rules (``param_specs``) come with ``--n_model``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from transformer_transducer_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class ZeroSlice:
    """This rank's part of a leaf: ``size`` rows from ``start`` on ``dim``."""

    dim: int
    start: int
    size: int

    def of(self, x: torch.Tensor) -> torch.Tensor:
        return x.narrow(self.dim, self.start, self.size)


def jax_dims(module: nn.Module, name: str, ndim: int) -> Tuple[int, ...]:
    """For each dimension of the JAX leaf, the port dimension that holds it."""
    if name == "weight" and isinstance(module, nn.Linear):
        return (1, 0)
    if name == "weight" and isinstance(module, nn.Conv2d):
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def zero_dim(shape: Sequence[int], n_data: int) -> Optional[int]:
    """JAX's rule on a leaf's shape: its largest dimension that divides by
    ``n_data`` (the first of equals), or None (a scalar, no divisible
    dimension, or one rank)."""
    free = [d for d, n in enumerate(shape) if n % n_data == 0]
    if n_data <= 1 or not shape or not free:
        return None
    return max(free, key=lambda d: shape[d])


def zero_param_shardings(model: nn.Module, mesh: Mesh) -> List[Optional[ZeroSlice]]:
    """This rank's slice of each of ``model.parameters()`` (None: whole)."""
    dims = {}
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            dims.setdefault(id(p), jax_dims(module, name, p.dim()))
    out: List[Optional[ZeroSlice]] = []
    for p in model.parameters():
        to_port = dims[id(p)]
        d = zero_dim([p.shape[i] for i in to_port], mesh.n_data)
        if d is None:
            out.append(None)
            continue
        size = p.shape[to_port[d]] // mesh.n_data
        out.append(ZeroSlice(to_port[d], mesh.rank * size, size))
    return out
