"""The data, model and pipe axes on ``torch.distributed`` (port of
``parallel/mesh.py``).

The JAX package runs one process over an N-device mesh and lets XLA emit
the collectives.  The port runs N processes, as ``torchrun`` launches them
(one a card, or several on one card through gloo), and names the
collectives itself: the gradients' mean (``training/train_step.py``), the
ZeRO-1 gather (``training/optim.py``), the evaluation's rows, the
tensor-parallel sums (``parallel/tensor.py``) and the pipeline's hops
(``parallel/pipeline.py``).  With no process group the world size is 1 and
no collective is called.

The ranks form JAX's ``(data, model, pipe)`` grid: ``np.asarray(devices)
.reshape(n_data, n_model, n_pipe)`` puts ``pipe`` minor, then ``model``, so
world rank ``r`` sits at data index ``r // (n_model * n_pipe)``, model
index ``r // n_pipe % n_model`` and pipe index ``r % n_pipe``.  The pipe
axis composes with the data axis only (``n_model`` 1 when ``n_pipe`` > 1,
as in JAX).  The ranks of one data index form a model group (they hold the
shards of one replica) or a pipe group (the stages of one replica's
encoder); either takes the same rows.  The ranks of one model and pipe
index form a data group: they hold the same shards or stage and average
their gradients.  Adjacent stages of a pipe group share a two-rank link
group, over which a hop is a broadcast.  The ``seq`` axis (sequence
parallelism) comes in a later slice and raises here.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"

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
    """This process's place on the ``(data, model, pipe)`` grid: its
    indices on the axes and its groups (None: the default group, when one
    axis spans the whole world, or no group at all).  ``pipe_ranks`` are
    the world ranks of this rank's pipe group in stage order, and
    ``prev_link`` / ``next_link`` the two-rank groups it shares with the
    stage before and after it (None at the ends).  A rank past the grid
    (``data_rank >= n_data``) is left unused, as JAX leaves a pool's
    remainder devices."""

    n_data: int = 1
    data_rank: int = 0
    data_group: Any = None
    n_model: int = 1
    model_rank: int = 0
    model_group: Any = None
    n_pipe: int = 1
    pipe_rank: int = 0
    pipe_group: Any = None
    pipe_ranks: Tuple[int, ...] = (0,)
    prev_link: Any = None
    next_link: Any = None

    def __deepcopy__(self, memo):
        return self          # immutable; a copied model shares the groups

    @property
    def shape(self) -> Dict[str, int]:
        shape = {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}
        if self.n_pipe > 1:
            shape[PIPE_AXIS] = self.n_pipe
        return shape

    @property
    def active(self) -> bool:
        return self.data_rank < self.n_data

    @property
    def is_main(self) -> bool:
        """The grid's first rank, which writes logs and checkpoints."""
        return self.data_rank == 0 and self.model_rank == 0 and self.pipe_rank == 0

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

    @property
    def pipelined(self) -> bool:
        """Whether the encoder runs in stages over a pipe group."""
        return self.n_pipe > 1

    @property
    def first_stage(self) -> bool:
        return self.pipe_rank == 0

    @property
    def last_stage(self) -> bool:
        return self.pipe_rank == self.n_pipe - 1

    @property
    def data_root(self) -> int:
        """The world rank of data index 0 in this rank's data group."""
        return self.model_rank * self.n_pipe + self.pipe_rank


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *,
              n_pipe: int = 1, n_seq: int = 1) -> Mesh:
    """The ``(data, model, pipe)`` grid over the default group's ranks.

    ``n_model`` and ``n_pipe`` are never shrunk (they set the parameters'
    layout): a world smaller than their product raises JAX's
    ``ValueError``.  ``n_data`` defaults to the world over them; an
    oversized request shrinks to the largest fit with JAX's warning (the
    remainder ranks unused).  ``n_pipe`` with ``n_model`` raises, as in
    JAX; ``n_seq`` above 1 raises: its path comes in a later slice.  Every
    rank makes every group, in the same order (``new_group`` is
    collective): one model group a data index, one pipe group a data
    index, the links between adjacent stages, then one data group a model
    and pipe index."""
    if (n_seq or 1) > 1:
        raise later("sequence parallelism (n_seq)")
    n_model, n_pipe = int(n_model or 1), int(n_pipe or 1)
    if n_pipe > 1 and n_model > 1:
        raise NotImplementedError("pipeline parallelism composes with the data "
                                  "axis only; set n_model=1 when n_pipe>1")
    fixed = n_model * n_pipe
    world = world_size()
    if world < fixed:
        raise ValueError(f"model x pipe x seq axes need {fixed} devices, "
                         f"have {world}")
    fit = world // fixed
    if n_data is None:
        n_data = fit
    elif n_data * fixed > world:
        _log.warning("mesh %dx%d needs %d devices, have %d; shrinking the "
                     "data axis to %d (%d device(s) left unused)",
                     n_data, fixed, n_data * fixed, world, fit,
                     world - fit * fixed)
        n_data = fit
    n_data = int(n_data)
    rank = world_rank()
    data_rank, rest = divmod(rank, fixed)
    model_rank, pipe_rank = divmod(rest, n_pipe)
    grid = np.arange(n_data * fixed).reshape(n_data, n_model, n_pipe)
    model_group = data_group = pipe_group = prev_link = next_link = None
    if n_model > 1:
        for d in range(n_data):
            group = dist.new_group(grid[d, :, 0].tolist())
            if d == data_rank:
                model_group = group
    pipe_ranks = (rank,)
    if n_pipe > 1:
        for d in range(n_data):
            ranks = grid[d, 0].tolist()
            group = dist.new_group(ranks)
            # two stages: the pipe group is the one link
            links = ([group] if n_pipe == 2 else
                     [dist.new_group(ranks[s:s + 2]) for s in range(n_pipe - 1)])
            if d == data_rank:
                pipe_group, pipe_ranks = group, tuple(ranks)
                prev_link = links[pipe_rank - 1] if pipe_rank > 0 else None
                next_link = links[pipe_rank] if pipe_rank < n_pipe - 1 else None
    # the data axis spans the default group only with no other axis and no
    # rank left over
    if n_data > 1 and (fixed > 1 or n_data < world):
        for m in range(n_model):
            for p in range(n_pipe):
                group = dist.new_group(grid[:, m, p].tolist())
                if (m, p) == (model_rank, pipe_rank) and data_rank < n_data:
                    data_group = group
    return Mesh(n_data=n_data, data_rank=data_rank, data_group=data_group,
                n_model=n_model, model_rank=model_rank, model_group=model_group,
                n_pipe=n_pipe, pipe_rank=pipe_rank, pipe_group=pipe_group,
                pipe_ranks=pipe_ranks, prev_link=prev_link, next_link=next_link)


def default_n_data(batch: int, n_model: int = 1, n_pipe: int = 1, pipe_micro: int = 0,
                   world: Optional[int] = None) -> int:
    """JAX's default data axis (``training/trainer.py:146-151``): the
    largest that divides the batch, and with a pipe axis its microbatch
    (``batch / pipe_micro``), at most the world over the other axes."""
    world = world_size() if world is None else world
    avail = max(world // (n_model * n_pipe), 1)
    per_micro = batch // (pipe_micro or 2 * n_pipe) if n_pipe > 1 else batch
    return max(d for d in range(1, avail + 1) if batch % d == 0 and per_micro % d == 0)


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


def _all_reduce_(tensors: Sequence[torch.Tensor], group, divisor: int = 1) -> None:
    """Sum ``tensors`` over ``group`` in place, in one all-reduce of their
    concatenation, then divide by ``divisor`` (when above 1)."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    if divisor > 1:
        flat /= divisor
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Average ``tensors`` over the data group in place, in one all-reduce
    of their concatenation (sum, then divide by n)."""
    if not mesh.parallel or not tensors:
        return
    _all_reduce_(tensors, mesh.data_group, mesh.n_data)


def sum_over_pipe_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Sum ``tensors`` over the pipe group in place, in one all-reduce of
    their concatenation."""
    if not mesh.pipelined or not tensors:
        return
    _all_reduce_(tensors, mesh.pipe_group)


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
