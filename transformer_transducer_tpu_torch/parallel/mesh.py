"""The data and model axes on ``torch.distributed`` (port of
``parallel/mesh.py``).

The JAX package runs one process over an N-device mesh and lets XLA emit
the collectives.  The port runs N processes, as ``torchrun`` launches them
(one a card, or several on one card through gloo), and names the
collectives itself: the gradients' mean (``training/train_step.py``), the
ZeRO-1 gather (``training/optim.py``), the evaluation's rows, and the
tensor-parallel sums (``parallel/tensor.py``).  With no process group the
world size is 1 and no collective is called.

The ranks form JAX's ``(data, model)`` grid: ``np.asarray(devices)
.reshape(n_data, n_model)`` puts ``model`` minor, so world rank ``r`` sits
at data index ``r // n_model`` and model index ``r % n_model``.  The ranks
of one data index form a model group: they hold the shards of one replica
and take the same rows.  The ranks of one model index form a data group:
they hold the same shards and average their gradients.  The ``pipe`` and
``seq`` axes (pipeline and sequence parallelism) come in later slices and
raise here.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_log = logging.getLogger("transformer_transducer_tpu")


def later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is ported in a later slice of the "
                               "PyTorch port")


def world_size() -> int:
    """Processes in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def backend_for(device: torch.device) -> str:
    """The backend a rank on ``device`` joins with: NCCL with a card a rank;
    gloo on the CPU, or when more local ranks (``LOCAL_WORLD_SIZE``, else
    ``WORLD_SIZE``) than cards share a card, which NCCL refuses (gloo's
    all-reduce also takes CUDA tensors)."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "gloo" if local > torch.cuda.device_count() else "nccl"


def init_distributed(device: torch.device) -> bool:
    """Join the process group that ``torchrun`` (or any launcher setting
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``)
    describes, with :func:`backend_for`'s backend; False, and nothing done,
    for a single process or a group that already exists."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    dist.init_process_group(backend_for(device), init_method="env://")
    return True


def local_device(device=None) -> Optional[str]:
    """The card of this rank under a launcher (``LOCAL_RANK`` modulo the
    cards present) when no device is given; else ``device`` as given."""
    if device is not None or "LOCAL_RANK" not in os.environ:
        return device
    if not torch.cuda.is_available():
        return None          # resolve_device raises, as with one process
    return f"cuda:{int(os.environ['LOCAL_RANK']) % torch.cuda.device_count()}"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the ``(data, model)`` grid: its indices on
    both axes and its two groups (None: the default group, when one axis
    spans the whole world, or no group at all).  A rank past the grid
    (``data_rank >= n_data``) is left unused, as JAX leaves a pool's
    remainder devices."""

    n_data: int = 1
    data_rank: int = 0
    data_group: Any = None
    n_model: int = 1
    model_rank: int = 0
    model_group: Any = None

    def __deepcopy__(self, memo):
        return self          # immutable; a copied model shares the groups

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def active(self) -> bool:
        return self.data_rank < self.n_data

    @property
    def is_main(self) -> bool:
        """The grid's first rank, which writes logs and checkpoints."""
        return self.data_rank == 0 and self.model_rank == 0

    @property
    def parallel(self) -> bool:
        """Whether the data axis's collectives run (more than one data
        rank)."""
        return self.n_data > 1

    @property
    def tensor_parallel(self) -> bool:
        """Whether the model axis's collectives run (more than one model
        rank)."""
        return self.n_model > 1


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *,
              n_pipe: int = 1, n_seq: int = 1) -> Mesh:
    """The ``(data, model)`` grid over the default group's ranks.

    ``n_model`` is never shrunk (it sets the parameters' layout): a world
    smaller than it raises JAX's ``ValueError``.  ``n_data`` defaults to
    the world over ``n_model``; an oversized request shrinks to the largest
    fit with JAX's warning (the remainder ranks unused).  ``n_pipe`` and
    ``n_seq`` above 1 raise: their paths come in later slices.  Every rank
    makes every group, in the same order (``new_group`` is collective):
    one model group a data index, then one data group a model index."""
    for n, what in ((n_pipe, "pipeline parallelism (n_pipe)"),
                    (n_seq, "sequence parallelism (n_seq)")):
        if (n or 1) > 1:
            raise later(what)
    n_model = int(n_model or 1)
    world = world_size()
    if world < n_model:
        raise ValueError(f"model x pipe x seq axes need {n_model} devices, "
                         f"have {world}")
    fit = world // n_model
    if n_data is None:
        n_data = fit
    elif n_data * n_model > world:
        _log.warning("mesh %dx%d needs %d devices, have %d; shrinking the "
                     "data axis to %d (%d device(s) left unused)",
                     n_data, n_model, n_data * n_model, world, fit,
                     world - fit * n_model)
        n_data = fit
    n_data = int(n_data)
    rank = world_rank()
    data_rank, model_rank = divmod(rank, n_model)
    grid = np.arange(n_data * n_model).reshape(n_data, n_model)
    model_group = data_group = None
    if n_model > 1:
        for d in range(n_data):
            group = dist.new_group(grid[d].tolist())
            if d == data_rank:
                model_group = group
    # the data axis spans the default group only with no model axis and no
    # rank left over
    if n_data > 1 and (n_model > 1 or n_data < world):
        for m in range(n_model):
            group = dist.new_group(grid[:, m].tolist())
            if m == model_rank and data_rank < n_data:
                data_group = group
    return Mesh(n_data=n_data, data_rank=data_rank, data_group=data_group,
                n_model=n_model, model_rank=model_rank, model_group=model_group)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch (numpy arrays or tensors with a
    leading batch axis): data index r keeps ``r*B/n : (r+1)*B/n``, the rows
    that ``P('data')`` gives JAX's devices of data index r; the ranks of a
    model group take the same rows."""
    if not mesh.parallel:
        return batch
    out = {}
    for key, value in batch.items():
        size = value.shape[0]
        if size % mesh.n_data:
            raise ValueError(f"{key}: {size} rows do not divide over "
                             f"{mesh.n_data} data ranks")
        part = size // mesh.n_data
        out[key] = value[mesh.data_rank * part:(mesh.data_rank + 1) * part]
    return out


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Average ``tensors`` over the data group in place, in one all-reduce
    of their concatenation (sum, then divide by n)."""
    if not mesh.parallel or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.n_data
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch's rows of a per-rank ``x`` (data index r's rows at
    ``r*b : (r+1)*b``), on every rank of the data group: an all-reduce of
    zero-padded rows,
    which gloo also runs on CUDA tensors.  Exact (each sum adds zeros),
    but for the sign of a zero."""
    if not mesh.parallel:
        return x
    b = x.shape[0]
    full = x.new_zeros((b * mesh.n_data, *x.shape[1:]))
    full[mesh.data_rank * b:(mesh.data_rank + 1) * b] = x
    dist.all_reduce(full, group=mesh.data_group)
    return full


def pad_rows(batch: Dict[str, np.ndarray], size: int):
    """Pad a partial final batch (``drop_last=False``) to ``size`` rows by
    repeating row 0; returns (padded, n_valid).  The rows then divide over
    the data ranks, and the padding rows' results are dropped."""
    n = len(batch["inputs"])
    if n >= size:
        return batch, n
    return ({k: np.concatenate([v, np.repeat(v[:1], size - n, axis=0)])
             for k, v in batch.items()}, n)
