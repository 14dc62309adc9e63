"""Optimizers and epoch-level LR control (port of ``training/optim.py``).

The JAX package builds an optax chain; this module reproduces its semantics,
not ``torch.optim``'s:

* clipping by global norm scales by ``max_norm / norm`` only when
  ``norm >= max_norm`` (optax ``clip_by_global_norm``; ``clip_grad_norm_``
  would divide by ``norm + 1e-6`` every step);
* the order is clip -> L2 weight decay (``grad += wd * param``, before the
  moments) -> momentum trace / Adam (b1 0.9, b2 0.98, eps 1e-8) / Adadelta ->
  ``-lr`` (``optim.py:71-99``);
* a step schedule (``optim.schedule: step_decay``) reads the count of
  applied updates before the update, starting at 0;
* ``grad_accum_steps = K`` is optax ``MultiSteps``: the running mean of K
  batches' gradients goes through the chain on every K-th call, the other
  calls change no parameter.

Parameters are updated in place; the moments are lists of tensors beside
them, updated with ``torch._foreach_*`` ops.

ZeRO-1 (``parallel.zero``, ``zero=(mesh, slices)`` from
``parallel/sharding.py::zero_param_shardings``): each data rank holds its
slice of every moment, updates its slice of each parameter from the whole
averaged gradient (the clip's norm is the whole gradient's, as every rank
holds it; the clip scales the slices alone) and then gathers the
parameters: each rank writes its updated slices into zeros and an
all-reduce sums them, in buckets of ``GATHER_BUCKET`` elements, so no
parameter-size buffer is held (gloo has no all-gather of CUDA tensors, and
NCCL refuses two ranks on one card; the sum adds zeros, so it is exact but
for the sign of a zero; it moves about twice an all-gather's bytes, which
NCCL with a card a rank could use instead).  Leaves that do not divide
stay whole and are updated alike on every rank.  The gradient accumulator
of ``grad_accum_steps`` stays whole.  ``state_dict`` gathers the moments,
so a checkpoint has the single-process format, and ``load_state_dict``
takes a whole state and keeps this rank's slices: ``-mode continue`` works
at any world size.

Tensor parallelism (``tp=(mesh, slices)`` from
``parallel/sharding.py::tp_slices``): the parameters are this model rank's
slices, and so are their moments (ZeRO-1's data slices are taken of them).
The global norm, of the clip and of the metrics, is the whole model's: the
squares of the sharded leaves summed over the model group, the replicated
leaves' counted once.  ``state_dict`` gathers the moments over the data
group and then over the model group, so a checkpoint holds them whole.

Pipeline parallelism (``pipe=(mesh, shapes)`` from
``parallel/sharding.py::pipe_plan``): a stage's parameter list holds the
other stages' leaves as empty tensors, whose moments are empty too.  The
global norm sums the stage-held leaves' squares over the pipe group and
counts the leaves every stage holds once (the ``tp`` pattern);
``state_dict`` gathers each stage's moments over the pipe group after the
data group, and ``load_state_dict`` keeps this stage's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from transformer_transducer_tpu_torch.parallel.sharding import stage_leaf, whole_leaf

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.98, 1e-8
GATHER_BUCKET = 1 << 23     # elements a ZeRO-1 gather sums at once (32 MiB)


def global_norm(tensors: Sequence[torch.Tensor], tp: Optional[Tuple] = None,
                pipe: Optional[Tuple] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax ``global_norm``);
    with ``tp=(mesh, slices)`` the whole model's, from this model rank's
    slices (a collective over the model group); with ``pipe=(mesh,
    shapes)`` the whole model's from this stage's leaves (a collective over
    the pipe group)."""
    norms = torch.stack(torch._foreach_norm(list(tensors)))
    if tp is None and pipe is None:
        return torch.linalg.vector_norm(norms)
    mesh, pieces = tp or pipe
    group = mesh.model_group if tp is not None else mesh.pipe_group
    split = torch.tensor([s is not None for s in pieces], device=norms.device)
    squares = norms.square()
    total = torch.where(split, squares, torch.zeros_like(squares)).sum()
    dist.all_reduce(total, group=group)
    return (total + torch.where(split, torch.zeros_like(squares), squares).sum()).sqrt()


class Optimizer:
    """clip -> L2 -> sgd | adam | adadelta -> -lr, optionally accumulated."""

    def __init__(self, params: Sequence[torch.Tensor], kind: str, lr: float,
                 momentum: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0, rho: float = 0.9, eps: float = 1e-6,
                 max_grad_norm: Optional[float] = None,
                 schedule: Optional[Callable[[int], float]] = None,
                 grad_accum_steps: int = 1, zero: Optional[Tuple] = None,
                 tp: Optional[Tuple] = None, pipe: Optional[Tuple] = None):
        if kind not in ("sgd", "adam", "adadelta"):
            raise NotImplementedError(f"optimizer type {kind!r}")
        self.params = list(params)
        self.kind = kind
        self.lr = float(lr)
        self.momentum, self.nesterov = float(momentum), bool(nesterov)
        self.weight_decay = float(weight_decay)
        self.rho, self.eps = float(rho), float(eps)
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule
        self.accum = max(1, int(grad_accum_steps))
        self.count = 0          # applied updates
        self.mini_step = 0      # batches accumulated towards the next update
        self.last_lr = schedule(0) if schedule else self.lr
        # ZeRO-1: (mesh, this rank's slice of each parameter or None)
        self.mesh, self.slices = zero or (None, [None] * len(self.params))
        # tensor parallelism: (mesh, each parameter's model slice or None)
        self.tp = tp
        # pipeline parallelism: (mesh, each stage leaf's whole shape or None)
        self.pipe = pipe
        zeros = lambda: [torch.zeros_like(self._mine(p, s))
                         for p, s in zip(self.params, self.slices)]
        self.state: Dict[str, List[torch.Tensor]] = {}
        if kind == "sgd" and self.momentum:
            self.state["trace"] = zeros()
        elif kind == "adam":
            self.state["mu"], self.state["nu"] = zeros(), zeros()
        elif kind == "adadelta":
            self.state["e_g"], self.state["e_x"] = zeros(), zeros()
        if self.accum > 1:
            self.state["acc"] = [torch.zeros_like(p) for p in self.params]

    @staticmethod
    def _mine(x: torch.Tensor, piece) -> torch.Tensor:
        return x if piece is None else piece.of(x)

    @property
    def zero(self) -> bool:
        return self.mesh is not None and any(s is not None for s in self.slices)

    def moment_bytes(self) -> int:
        """Bytes of the moments this rank holds (not the accumulator)."""
        return sum(t.numel() * t.element_size() for key, ts in self.state.items()
                   if key != "acc" for t in ts)

    # -- the learning rate, as optax ``inject_hyperparams`` holds it
    @property
    def learning_rate(self) -> float:
        """The rate of the last update under a schedule, else the set rate."""
        return self.last_lr if self.schedule else self.lr

    @learning_rate.setter
    def learning_rate(self, lr: float) -> None:
        self.lr = float(lr)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Take one batch's gradients (aligned with ``params``); under
        accumulation only every K-th call updates the parameters."""
        grads = list(grads)
        if self.accum > 1:
            acc = self.state["acc"]
            delta = torch._foreach_sub(grads, acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(acc, delta)
            if self.mini_step < self.accum - 1:
                self.mini_step += 1
                return
            self.mini_step = 0
            grads = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
        self._update(grads)

    def _update(self, grads: List[torch.Tensor]) -> None:
        norm = global_norm(grads, self.tp, self.pipe) if self.max_grad_norm else None
        # ZeRO-1: from here on this rank's slices (views of the parameters);
        # the clip's norm is the whole gradient's, its scaling the slices'
        params = [self._mine(p, s) for p, s in zip(self.params, self.slices)]
        grads = [self._mine(g, s) for g, s in zip(grads, self.slices)]
        if norm is not None:
            factor = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                                 self.max_grad_norm / norm)
            grads = torch._foreach_mul(grads, factor)
        if self.weight_decay:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        if self.kind == "sgd":
            updates = grads
            if self.momentum:
                trace = self.state["trace"]
                torch._foreach_mul_(trace, self.momentum)
                torch._foreach_add_(trace, grads)
                updates = (torch._foreach_add(grads, trace, alpha=self.momentum)
                           if self.nesterov else trace)
        elif self.kind == "adam":
            mu, nu = self.state["mu"], self.state["nu"]
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, grads, alpha=1 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - ADAM_B2)
            c = self.count + 1
            mu_hat = torch._foreach_div(mu, 1 - ADAM_B1 ** c)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - ADAM_B2 ** c))
            torch._foreach_add_(denom, ADAM_EPS)
            updates = torch._foreach_div(mu_hat, denom)
        else:   # adadelta
            e_g, e_x = self.state["e_g"], self.state["e_x"]
            torch._foreach_mul_(e_g, self.rho)
            torch._foreach_addcmul_(e_g, grads, grads, value=1 - self.rho)
            num = torch._foreach_sqrt(torch._foreach_add(e_x, self.eps))
            den = torch._foreach_sqrt(torch._foreach_add(e_g, self.eps))
            updates = torch._foreach_mul(torch._foreach_div(num, den), grads)
            torch._foreach_mul_(e_x, self.rho)
            torch._foreach_addcmul_(e_x, updates, updates, value=1 - self.rho)
        lr = self.schedule(self.count) if self.schedule else self.lr
        self.last_lr = lr
        torch._foreach_add_(params, updates, alpha=-lr)
        if self.zero:
            for i, whole in self._gather(params):
                self.params[i].copy_(whole)
        self.count += 1

    def _gather(self, parts: Sequence[torch.Tensor]
                ) -> Iterator[Tuple[int, torch.Tensor]]:
        """``(i, whole)`` for each split leaf i: the whole tensor, in the
        parameter's shape, from every rank's slices ``parts``.  Each rank
        writes its slices into zeros and an all-reduce sums them, a bucket
        of at most ``GATHER_BUCKET`` elements (or one larger leaf) at a
        time, so that the gather holds no parameter-size buffer."""
        split = [i for i, s in enumerate(self.slices) if s is not None]
        while split:
            bucket, n = [], 0
            while split and (not bucket
                             or n + self.params[split[0]].numel() <= GATHER_BUCKET):
                bucket.append(split.pop(0))
                n += self.params[bucket[-1]].numel()
            flat = self.params[0].new_zeros(n)
            wholes, offset = [], 0
            for i in bucket:
                size = self.params[i].numel()
                wholes.append(flat[offset:offset + size].view_as(self.params[i]))
                self.slices[i].of(wholes[-1]).copy_(parts[i])
                offset += size
            dist.all_reduce(flat, group=self.mesh.data_group)
            yield from zip(bucket, wholes)

    # -- checkpoints
    @torch.no_grad()
    def state_dict(self) -> dict:
        """The state in the single-process format: under ZeRO-1 and tensor
        parallelism the moments gathered whole (a collective: every rank
        calls it)."""
        state = {}
        for key, tensors in self.state.items():
            state[key] = [t.clone() for t in tensors]
            if self.zero and key != "acc":
                for i, whole in self._gather(tensors):
                    state[key][i] = whole.clone()
            if self.tp is not None:
                mesh, pieces = self.tp
                state[key] = [t if piece is None else whole_leaf(t, piece, mesh)
                              for t, piece in zip(state[key], pieces)]
            if self.pipe is not None:
                mesh, shapes = self.pipe
                state[key] = [t if shape is None else stage_leaf(t, shape, mesh)
                              for t, shape in zip(state[key], shapes)]
        return {"kind": self.kind, "count": self.count,
                "mini_step": self.mini_step, "lr": self.lr,
                "last_lr": self.last_lr, "state": state}

    def load_state_dict(self, sd: dict) -> None:
        if sd["kind"] != self.kind or set(sd["state"]) != set(self.state):
            raise ValueError(f"optimizer state of {sd['kind']!r} with "
                             f"{sorted(sd['state'])} does not fit {self.kind!r} "
                             f"with {sorted(self.state)}")
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        self.lr, self.last_lr = float(sd["lr"]), float(sd["last_lr"])
        model_pieces = self.tp[1] if self.tp is not None else [None] * len(self.params)
        for key, tensors in sd["state"].items():
            slices = self.slices if key != "acc" else [None] * len(tensors)
            for dst, src, piece, mp in zip(self.state[key], tensors, slices, model_pieces,
                                           strict=True):
                if dst.numel() == 0:        # another stage's leaf
                    continue
                dst.copy_(self._mine(self._mine(src.to(dst.device), mp), piece))


def step_decay_lr(step: int, warmup_steps: float = 4e3, hold_steps: float = 3e4,
                  final_step: float = 2.3e5, init_lr: float = 1e-6,
                  max_lr: float = 2.5e-4, min_lr: float = 2.5e-6) -> float:
    """Linear warmup to ``max_lr``, hold, then exponential decay to
    ``min_lr`` at ``final_step`` (the working version of the reference's
    ``step_decay_lr``, ``tt/optim.py:35-55``)."""
    if step < warmup_steps:   # strict: warmup_steps == 0 disables warmup
        return init_lr + (max_lr - init_lr) * step / warmup_steps
    if step <= hold_steps:
        return max_lr
    frac = min(1.0, (step - hold_steps) / (final_step - hold_steps))
    return max_lr * math.exp(frac * math.log(min_lr / max_lr))


def build_optimizer(config, params: Sequence[torch.Tensor],
                    max_grad_norm: Optional[float] = None,
                    grad_accum_steps: int = 1, zero: Optional[Tuple] = None,
                    tp: Optional[Tuple] = None, pipe: Optional[Tuple] = None) -> Optimizer:
    """sgd/adam/adadelta from a reference-schema ``optim:`` block
    (``zero``: ZeRO-1's ``(mesh, slices)``, ``tp``: tensor parallelism's,
    ``pipe``: pipeline parallelism's; see :class:`Optimizer`).

    ``schedule: step_decay`` selects :func:`step_decay_lr` per update, with
    ``lr`` as its ``max_lr`` (knobs ``warmup_steps``, ``hold_steps``,
    ``final_step``, ``init_lr``, ``min_lr``; an explicit 0 stays 0)."""
    schedule = None
    if config.schedule == "step_decay":
        knob = lambda value, default: default if value is None else value
        schedule = functools.partial(
            step_decay_lr, warmup_steps=knob(config.warmup_steps, 4e3),
            hold_steps=knob(config.hold_steps, 3e4),
            final_step=knob(config.final_step, 2.3e5),
            init_lr=knob(config.init_lr, 1e-6), max_lr=config.lr,
            min_lr=knob(config.min_lr, 2.5e-6))
    elif config.schedule is not None:
        raise NotImplementedError(f"optim.schedule {config.schedule!r}")
    return Optimizer(params, config.type, config.lr,
                     momentum=config.momentum or 0.0,
                     nesterov=bool(config.nesterov),
                     weight_decay=config.weight_decay or 0.0,
                     rho=config.rho or 0.9, eps=config.eps or 1e-6,
                     max_grad_norm=max_grad_norm, schedule=schedule,
                     grad_accum_steps=grad_accum_steps, zero=zero, tp=tp, pipe=pipe)


@dataclasses.dataclass
class LRController:
    """Epoch-level LR state machine (reference ``Optimizer.decay_lr`` and the
    trainer loop, ``train.py:256-263``)."""

    lr: float
    decay_ratio: float
    begin_to_adjust: int
    min_lr: float = 1e-6

    def maybe_decay(self, epoch: int) -> bool:
        """Decay after ``epoch`` if due; False when training should stop
        (the rate fell below ``min_lr``)."""
        if epoch >= self.begin_to_adjust:
            self.lr *= self.decay_ratio
            if self.lr < self.min_lr:
                return False
        return True
