"""One rank of a multi-process run of the PyTorch port, for
``tests/test_torch_port_parallel.py`` (data parallelism) and
``tests/test_torch_port_tensor_parallel.py`` (gloo on the CPU; no JAX).

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
  ``pruned`` (the pruned loss's band), ``seed`` (dropout drawn from
  seed + the data index, and SpecAugment from a generator seeded alike on
  every rank); ``steps`` train steps on this rank's rows of ``batch``,
  with a NaN in the global row ``nan_row`` at step ``nan_step`` when
  given (on the model rank ``nan_model_rank`` alone, when given).
  Returns the losses, gradient norms and skips, the parameters (whole:
  gathered under tensor parallelism), this rank's own parameters, the
  optimizer's own state (this rank's moment slices), the ZeRO-1 and model
  slices, the moment bytes and the gathered ``state_dict``.
* ``roundtrip``: ``shard_model`` then ``gather_model`` of a model
  (``model_cfg``, ``state``) over ``n_model`` ranks: the local shapes, and
  the whole state dict after the gather.
* ``mesh``: ``make_mesh()`` and ``make_mesh(n_data=world + 1)`` and the
  warnings the latter logged; with ``n_model``, the grid place and groups'
  members of ``make_mesh(n_model=n_model)``.
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
        gathered_state_dict, shard_model, sharded, tp_plan, zero_param_shardings)
    from transformer_transducer_tpu_torch.training import optim
    from transformer_transducer_tpu_torch.training.optim import build_optimizer
    from transformer_transducer_tpu_torch.training.train_step import (
        TrainStepConfig, batch_to_device, make_train_step)
    from transformer_transducer_tpu_torch.utils.config import Config

    if "bucket" in case:
        optim.GATHER_BUCKET = case["bucket"]

    model = build_model(case)
    model.train()
    mesh = make_mesh(n_data=case["n_data"], n_model=case.get("n_model", 1))
    shard_model(model, mesh)
    tp = tp_plan(model)
    slices = zero_param_shardings(model, mesh) if case["zero"] else None
    opt = build_optimizer(Config(dict(case["optim"])), list(model.parameters()),
                          max_grad_norm=200.0, grad_accum_steps=case.get("accum", 1),
                          zero=(mesh, slices) if case["zero"] else None, tp=tp)
    gen = None
    if "seed" in case:
        torch.manual_seed(case["seed"] + mesh.data_rank)
        gen = torch.Generator().manual_seed(case["seed"])
    step = make_train_step(model, opt, TrainStepConfig(
        specaug=gen is not None, nan_guard=case.get("nan_guard", False),
        loss_pruned_range=case.get("pruned")), mesh=mesh)
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
    whole = gathered_state_dict(model) if tp else model.state_dict()
    out.update(params={k: v.detach().clone() for k, v in whole.items()},
               local={k: v.detach().clone() for k, v in model.state_dict().items()},
               moments={k: [t.clone() for t in v] for k, v in opt.state.items()},
               slices=slices, tp_slices=sharded(model), moment_bytes=opt.moment_bytes(),
               state_dict=opt.state_dict(), names=[n for n, _ in model.named_parameters()],
               data_rank=mesh.data_rank, model_rank=mesh.model_rank)
    return out


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
        if "n_model" in case:
            mesh = make_mesh(n_model=case["n_model"])
            members = lambda g: None if g is None else dist.get_process_group_ranks(g)
            return {"shape": mesh.shape, "data_rank": mesh.data_rank,
                    "model_rank": mesh.model_rank, "model_group": members(mesh.model_group),
                    "data_group": members(mesh.data_group), "is_main": mesh.is_main}
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
            "zero": trainer.zero, "moment_bytes": trainer.optimizer.moment_bytes(),
            "global_step": trainer.global_step, "backend": dist.get_backend(),
            "rng": torch.get_rng_state(), "exp_dir": trainer.exp_dir,
            "local": {k: v.clone() for k, v in trainer.model.state_dict().items()}}


def main(job_path: str) -> None:
    job = torch.load(job_path, weights_only=False)
    if job["cases"][0]["kind"] != "cli":
        dist.init_process_group("gloo", init_method="env://")
    runs = {"steps": run_steps, "mesh": run_mesh, "cli": run_cli,
            "roundtrip": run_roundtrip}
    results = [runs[case["kind"]](case) for case in job["cases"]]
    torch.save(results, f"{job['out']}{dist.get_rank()}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
