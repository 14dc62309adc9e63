"""The collectives of tensor parallelism (the ``model`` axis).

The JAX package shards the parameters by ``parallel/sharding.py``'s rules
and lets GSPMD insert the collectives.  The port names them, as Megatron-LM
does (Shoeybi et al., arXiv:1909.08053): a column-parallel product (this
rank's output columns) takes its replicated input through
:func:`copy_to_model`, whose backward sums the input's gradient over the
model group; a row-parallel product (this rank's input rows) gives a
partial sum, which :func:`reduce_from_model` sums over the model group
before the whole bias is added once.  ``tp`` is the
:class:`~parallel.mesh.Mesh` of a model that ``shard_model`` narrowed, or
None; with None (or one model rank) every function here returns what one
process computes, by the same operations.

Sums run in float32: a bf16 tensor is widened for the all-reduce and
rounded once after it.  A bf16 row-parallel product sums float32 partials
of bf16-rounded operands, so it rounds to bf16 once, after the sum, as one
process's bf16 product rounds once.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from transformer_transducer_tpu_torch.ops.precision import dense, to_compute, widen


def tensor_parallel(tp) -> bool:
    return tp is not None and tp.n_model > 1


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in float32, in ``x``'s dtype."""
    buf = x.to(torch.float32, copy=True, memory_format=torch.contiguous_format)
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the model
    group (the input of a column-parallel product)."""
    return _CopyToModel.apply(x, tp.model_group) if tensor_parallel(tp) else x


def reduce_from_model(x: torch.Tensor, tp) -> torch.Tensor:
    """The sum over the model group forward; identity backward (the output
    of a row-parallel product)."""
    return _ReduceFromModel.apply(x, tp.model_group) if tensor_parallel(tp) else x


def row_product(x: torch.Tensor, w: torch.Tensor, tp,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ w`` in ``compute_dtype``, ``w`` (in, out) holding this rank's
    rows of a row-parallel weight: the partial products summed over the
    model group."""
    cd = compute_dtype
    if not tensor_parallel(tp):
        return to_compute(x, cd) @ to_compute(w, cd)
    if cd == torch.float32:
        return reduce_from_model(x @ w, tp)
    return reduce_from_model(widen(x.to(cd)) @ widen(w.to(cd)), tp).to(cd)


def row_parallel(layer: nn.Module, x: torch.Tensor, tp,
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``dense(layer, x)`` of a row-parallel ``nn.Linear`` (this rank's
    input columns of its weight): the partial products summed over the
    model group, then the whole bias, added once."""
    if not tensor_parallel(tp):
        return dense(layer, x, compute_dtype)
    y = row_product(x, layer.weight.t(), tp, compute_dtype)
    return y if layer.bias is None else y + to_compute(layer.bias, compute_dtype)


def column_input(x: torch.Tensor, tp,
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The input of column-parallel products: ``x`` in ``compute_dtype``
    through :func:`copy_to_model` (its gradient summed in that dtype's
    rounding, as one process sums the products' gradients)."""
    return copy_to_model(to_compute(x, compute_dtype), tp)


def sharded_dropout(drop: nn.Dropout, x: torch.Tensor, tp, dim: int) -> torch.Tensor:
    """``drop(x)`` of a sharded activation (this rank's part of ``dim``).
    Under tensor parallelism the mask is drawn at the whole width and
    narrowed to this rank's part: the ranks of a model group draw alike
    (they are seeded by their data index), so each keeps its own units of
    one whole-width mask, whose units are independent."""
    if not tensor_parallel(tp) or not drop.training or drop.p == 0.0:
        return drop(x)
    size = x.shape[dim]
    full = list(x.shape)
    full[dim] = size * tp.n_model
    keep = torch.empty(full, dtype=x.dtype, device=x.device).bernoulli_(1.0 - drop.p)
    return x * keep.narrow(dim, tp.model_rank * size, size) * (1.0 / (1.0 - drop.p))
