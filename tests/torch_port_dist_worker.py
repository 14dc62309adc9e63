"""One rank of a multi-process run of the PyTorch port, for
``tests/test_torch_port_parallel.py`` (data parallelism),
``tests/test_torch_port_tensor_parallel.py``,
``tests/test_torch_port_pipeline.py`` and
``tests/test_torch_port_sequence.py`` (gloo on the CPU; no JAX).

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_port_dist_worker.py JOB.pt

``JOB.pt`` (``torch.save``) holds ``{"cases": [...], "out": prefix}``; this
rank runs every case in order and writes ``{prefix}{rank}.pt``, a list of
one result a case.  Cases:

* ``steps``: a model (``model_cfg``, ``flash``, ``banded``, ``remat``,
  ``compute_dtype``, ``state``), an optimizer
  (``optim``, clip 200, ``accum``), ``zero``, ``n_data``, ``nan_guard``,
  ``bucket`` (the ZeRO-1 gather's bucket in elements, when given),
  ``n_model`` (tensor parallelism: the model sharded over that many ranks),
  ``n_pipe`` and ``pipe_micro`` (pipeline parallelism: the encoder split
  into that many stages, that many microbatches a step), ``n_seq`` and
  ``sp_window`` (sequence parallelism: the encoder's time axis in that
  many shards, windows of that many rows),
  ``pruned`` (the pruned loss's band), ``seed`` (dropout drawn from
  seed + the data index, and SpecAugment from a generator seeded alike on
  every rank); ``steps`` train steps on this rank's rows of ``batch``,
  with a NaN in the global row ``nan_row`` at step ``nan_step`` when
  given (on the model rank ``nan_model_rank`` alone, when given).
  Returns the losses, gradient norms and skips, the parameters (whole:
  gathered under tensor parallelism), this rank's own parameters, the
  optimizer's own state (this rank's moment slices), the ZeRO-1 and model
  slices, the moment bytes and the gathered ``state_dict``; with ``grads``
  step 1's gradients as the optimizer took them (after the data mean).
* ``encode``: the pipelined encoder (``n_pipe`` stages, ``n_micro``
  microbatches, ``n_data`` 1: the ranks past the pipe group idle) of a
  model on ``x`` (``mask``, ``band``; the espnet family with ``lengths``):
  the output on every stage; with ``grad``, the encoder parameters'
  gradients of ``sum(h ** 2)`` through the schedule, by name, on the stage
  that holds them.
* ``sp_encode``: the sequence-parallel encoder (``n_seq`` shards,
  ``n_data`` 1: the ranks past the seq group idle) of a model on ``x``:
  native with ``band`` and ``window``, the espnet family with
  ``lengths``; the whole output on every shard (and the espnet lengths);
  with ``grad``, the encoder parameters' gradients of ``sum(h ** 2)``,
  summed over the seq group, by name.
* ``roundtrip``: ``shard_model`` then ``gather_model`` of a model
  (``model_cfg``, ``state``) over ``n_model`` ranks: the local shapes, and
  the whole state dict after the gather.
* ``mesh``: ``make_mesh()`` and ``make_mesh(n_data=world + 1)`` and the
  warnings the latter logged; with ``n_model``, ``n_pipe`` or ``n_seq``,
  the grid place and groups' members of ``make_mesh(n_data=...,
  n_model=..., n_pipe=..., n_seq=...)``.
* ``cli``: ``apps/train.py``'s ``main(argv)`` from ``cwd``.  A job whose
  first case is ``cli`` leaves the group to the entry point, which joins
  it from the environment, as under ``torchrun``.
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)


def build_model(case):
    from transformer_transducer_tpu_torch.models.factory import build_family
    from transformer_transducer_tpu_torch.utils.config import Config
    model = build_family(Config({"model": case["model_cfg"]}), flash=case.get("flash", False),
                         banded=case.get("banded", False), remat=case.get("remat", False),
                         compute_dtype=case.get("compute_dtype", torch.float32), device="cpu")
    model.load_state_dict(case["state"])
    return model


def run_steps(case):
    from transformer_transducer_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from transformer_transducer_tpu_torch.parallel.sharding import (
        gathered_state_dict, pipe_model, pipe_plan, shard_model, sharded, tp_plan,
        zero_param_shardings)
    from transformer_transducer_tpu_torch.training import optim
    from transformer_transducer_tpu_torch.training.optim import build_optimizer
    from transformer_transducer_tpu_torch.training.train_step import (
        TrainStepConfig, batch_to_device, make_train_step)
    from transformer_transducer_tpu_torch.utils.config import Config

    if "bucket" in case:
        optim.GATHER_BUCKET = case["bucket"]

    model = build_model(case)
    model.train()
    mesh = make_mesh(n_data=case["n_data"], n_model=case.get("n_model", 1),
                     n_pipe=case.get("n_pipe", 1), n_seq=case.get("n_seq", 1))
    shard_model(model, mesh)
    pipe_model(model, mesh)
    tp = tp_plan(model)
    slices = zero_param_shardings(model, mesh) if case["zero"] else None
    opt = build_optimizer(Config(dict(case["optim"])), list(model.parameters()),
                          max_grad_norm=200.0, grad_accum_steps=case.get("accum", 1),
                          zero=(mesh, slices) if case["zero"] else None, tp=tp,
                          pipe=pipe_plan(model))
    gen = None
    if "seed" in case:
        torch.manual_seed(case["seed"] + mesh.data_rank)
        gen = torch.Generator().manual_seed(case["seed"])
    step = make_train_step(model, opt, TrainStepConfig(
        specaug=gen is not None, nan_guard=case.get("nan_guard", False),
        loss_pruned_range=case.get("pruned"), pipe_micro=case.get("pipe_micro", 0),
        sp_window=case.get("sp_window", 0)), mesh=mesh)
    out = {"loss": [], "grad_norm": [], "skipped": []}
    for i in range(case["steps"]):
        batch = {k: np.array(v) for k, v in case["batch"].items()}
        if case.get("nan_step") == i and case.get("nan_model_rank", mesh.model_rank) \
                == mesh.model_rank:
            batch["inputs"][case["nan_row"]] = np.nan
        m = step(batch_to_device(shard_batch(batch, mesh), "cpu"), gen)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["skipped"].append(int(m.get("skipped", 0)))
        if case.get("grads") and i == 0:
            out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
    whole = gathered_state_dict(model) if tp or mesh.pipelined else model.state_dict()
    out.update(params={k: v.detach().clone() for k, v in whole.items()},
               local={k: v.detach().clone() for k, v in model.state_dict().items()},
               moments={k: [t.clone() for t in v] for k, v in opt.state.items()},
               slices=slices, tp_slices=sharded(model), moment_bytes=opt.moment_bytes(),
               state_dict=opt.state_dict(), names=[n for n, _ in model.named_parameters()],
               data_rank=mesh.data_rank, model_rank=mesh.model_rank,
               pipe_rank=mesh.pipe_rank, seq_rank=mesh.seq_rank)
    return out


def run_encode(case):
    from transformer_transducer_tpu_torch.parallel.mesh import make_mesh
    from transformer_transducer_tpu_torch.parallel.pipeline import (
        Pipeline, encode_pipelined, encode_pipelined_espnet)
    from transformer_transducer_tpu_torch.parallel.sharding import pipe_model
    model = build_model(case).eval()
    mesh = make_mesh(n_data=1, n_pipe=case["n_pipe"])
    if not mesh.active:
        return None
    pipe_model(model, mesh)
    x = torch.from_numpy(case["x"])
    if case.get("grad"):
        pipe = Pipeline(model, mesh, case["n_micro"])
        h = pipe.forward(x if mesh.first_stage else None, x.shape[0], x.shape[1],
                         attn_mask=case.get("mask"), band=case.get("band"))
        if mesh.last_stage:
            (h ** 2).sum().backward()
        pipe.backward(h.grad if mesh.last_stage else None)
        return {"grads": {n: p.grad.clone() for n, p in model.named_parameters()
                          if n.startswith("encoder.") and p.grad is not None}}
    mine = x if mesh.first_stage else None
    if "lengths" in case:
        out, lens = encode_pipelined_espnet(model, mine, torch.from_numpy(case["lengths"]),
                                            mesh, case["n_micro"], rows=x.shape[0],
                                            t_in=x.shape[1])
        return {"out": out, "lengths": lens}
    return {"out": encode_pipelined(model, mine, mesh, case["n_micro"],
                                    attn_mask=case.get("mask"), band=case.get("band"),
                                    rows=x.shape[0], t_in=x.shape[1])}


def run_sp_encode(case):
    from transformer_transducer_tpu_torch.parallel.mesh import make_mesh, sum_over_seq_
    from transformer_transducer_tpu_torch.parallel.sequence import (
        encode_banded_sp, encode_banded_sp_espnet)
    model = build_model(case).eval()
    mesh = make_mesh(n_data=1, n_seq=case["n_seq"])
    if not mesh.active:
        return None
    x = torch.from_numpy(case["x"])
    if "lengths" in case:
        with torch.no_grad():
            out, lens = encode_banded_sp_espnet(model, x, torch.from_numpy(case["lengths"]),
                                                mesh)
        return {"out": out, "lengths": lens}
    with torch.set_grad_enabled(bool(case.get("grad"))):
        h = encode_banded_sp(model, x, mesh, *case["band"], window_len=case.get("window"))
    if not case.get("grad"):
        return {"out": h}
    (h ** 2).sum().backward()
    named = [(n, p) for n, p in model.named_parameters() if n.startswith("encoder.")]
    grads = [p.grad for _, p in named]
    sum_over_seq_(grads, mesh)
    return {"out": h.detach(), "grads": {n: g.clone() for (n, _), g in zip(named, grads)}}


def run_roundtrip(case):
    from transformer_transducer_tpu_torch.parallel.mesh import make_mesh
    from transformer_transducer_tpu_torch.parallel.sharding import gather_model, shard_model
    model = build_model(case)
    shard_model(model, make_mesh(n_model=case["n_model"]))
    local = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    gather_model(model)
    return {"local": local, "whole": {k: v.clone() for k, v in model.state_dict().items()},
            "tp": model.tp, "modules_tp": [m.tp for m in model.modules() if hasattr(type(m), "tp")]}


def run_mesh(case):
    from transformer_transducer_tpu_torch.parallel.mesh import make_mesh
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())
    handler = Keep(level=logging.WARNING)
    logging.getLogger("transformer_transducer_tpu").addHandler(handler)
    try:
        if "n_model" in case or "n_pipe" in case or "n_seq" in case:
            mesh = make_mesh(n_data=case.get("n_data"), n_model=case.get("n_model", 1),
                             n_pipe=case.get("n_pipe", 1), n_seq=case.get("n_seq", 1))
            members = lambda g: None if g is None else dist.get_process_group_ranks(g)
            return {"shape": mesh.shape, "data_rank": mesh.data_rank,
                    "model_rank": mesh.model_rank, "model_group": members(mesh.model_group),
                    "data_group": members(mesh.data_group), "is_main": mesh.is_main,
                    "pipe_rank": mesh.pipe_rank, "pipe_group": members(mesh.pipe_group),
                    "pipe_ranks": mesh.pipe_ranks, "prev_link": members(mesh.prev_link),
                    "next_link": members(mesh.next_link), "seq_rank": mesh.seq_rank,
                    "seq_group": members(mesh.seq_group), "seq_ranks": mesh.seq_ranks,
                    "prev_seq_link": members(mesh.prev_seq_link),
                    "next_seq_link": members(mesh.next_seq_link),
                    "data_root": mesh.data_root}
        default = make_mesh().n_data
        shrunk = make_mesh(n_data=dist.get_world_size() + 1).n_data
    finally:
        logging.getLogger("transformer_transducer_tpu").removeHandler(handler)
    return {"default": default, "shrunk": shrunk, "warnings": seen}


def run_cli(case):
    from transformer_transducer_tpu_torch.apps import train
    os.chdir(case["cwd"])
    trainer = train.main(case["argv"])
    return {"n_data": trainer.mesh.n_data, "n_model": trainer.mesh.n_model,
            "n_pipe": trainer.mesh.n_pipe, "pipe_micro": trainer.pipe_micro,
            "n_seq": trainer.mesh.n_seq,
            "zero": trainer.zero, "moment_bytes": trainer.optimizer.moment_bytes(),
            "global_step": trainer.global_step, "backend": dist.get_backend(),
            "rng": torch.get_rng_state(), "exp_dir": trainer.exp_dir,
            "local": {k: v.clone() for k, v in trainer.model.state_dict().items()}}


def main(job_path: str) -> None:
    job = torch.load(job_path, weights_only=False)
    if job["cases"][0]["kind"] != "cli":
        dist.init_process_group("gloo", init_method="env://")
    runs = {"steps": run_steps, "mesh": run_mesh, "cli": run_cli,
            "roundtrip": run_roundtrip, "encode": run_encode, "sp_encode": run_sp_encode}
    results = [runs[case["kind"]](case) for case in job["cases"]]
    torch.save(results, f"{job['out']}{dist.get_rank()}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
