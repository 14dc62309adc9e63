"""Training: the program's train step, closed-loop, one batch after the
other's loss has reached the host.

Set-up builds the model (``models/factory.py::build_family``), loads the
seeded weights, builds the optimizer (``training/optim.py::build_optimizer``)
and the step (``training/train_step.py::make_train_step``) as the trainer
does, and drives that same step through its first three batches by the
window's own call, which also warms up every shape.  The window continues
with the next batches.  ``check`` then frees the program, replays the three
steps in the plain reference with the run's dropout and SpecAugment
streams, and compares each step's loss, the first step's clipped gradient
(the momentum trace after one step) and the parameters' change over the
three, leaf by leaf by their norms.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.mix import Mix, seed_words

CHECKED_STEPS = 3


def _program():
    from transformer_transducer_tpu_torch.data.dataset import pad_raw_wave
    from transformer_transducer_tpu_torch.models.factory import build_family
    from transformer_transducer_tpu_torch.training import optim, train_step
    from transformer_transducer_tpu_torch.utils.config import Config
    return pad_raw_wave, build_family, optim, train_step, Config


def mix_of(ctx) -> Mix:
    data, t = ctx.cfg["data"], ctx.traffic
    return Mix(t["utterances"], t["batch"], data["max_input_length"], data["subsample"],
               ctx.cfg["model"]["vocab_size"], ctx.seed)


def host_batch(mix: Mix, max_labels: int, utts, pad_raw_wave) -> Dict[str, np.ndarray]:
    """A batch in the loader's on-device-features layout: padded int16
    waves, sample counts, zero-padded targets and their counts."""
    waves, counts = zip(*(pad_raw_wave(u.wave, mix.cap, mix.total) for u in utts))
    targets = np.zeros((len(utts), max_labels), np.int64)
    for i, u in enumerate(utts):
        targets[i, :len(u.labels)] = u.labels
    return {"inputs": np.stack(waves), "inputs_length": np.asarray(counts, np.int64),
            "targets": targets,
            "targets_length": np.asarray([len(u.labels) for u in utts], np.int64)}


class State:
    pass


def pruned_of(traffic: Dict):
    """``(s_range, simple_scale)`` of a pruned-loss traffic, else None."""
    if not traffic.get("pruned_range"):
        return None
    return traffic["pruned_range"], traffic["simple_scale"]


def setup(ctx) -> State:
    pad_raw_wave, build_family, optim, train_step, Config = _program()
    from benchmark import weights
    cfg, t = ctx.cfg, ctx.traffic
    s = State()
    s.mix = mix_of(ctx)
    s.pool = [s.mix.utterances(i) for i in range(t["pool_batches"])]
    s.host = [host_batch(s.mix, cfg["data"]["max_target_length"], u, pad_raw_wave)
              for u in s.pool]
    config = Config(cfg)
    model = build_family(config, device=ctx.device, flash=cfg["encoder"] == "flash",
                         banded=cfg["encoder"] == "banded").train()
    model.load_state_dict(weights.make(weights.spec(cfg["model"]),
                                       seed_words(ctx.seed, 2), ctx.device))
    s.names = [n for n, _ in model.named_parameters()]
    opt = optim.build_optimizer(config.optim, list(model.parameters()),
                                max_grad_norm=config.training.max_grad_norm)
    data = config.data
    frontend = (data.feature_dim, data.left_context_width, data.right_context_width,
                data.subsample, data.max_input_length, "eps")
    pruned = pruned_of(t)
    step_cfg = train_step.TrainStepConfig(
        frontend=frontend, specaug=bool(t["specaug"]),
        loss_pruned_range=pruned and pruned[0], loss_simple_scale=pruned[1] if pruned else 0.0)
    s.model, s.opt = model, opt
    s.step = train_step.make_train_step(model, opt, step_cfg)
    s.to_device = train_step.batch_to_device
    s.gen = torch.Generator().manual_seed(seed_words(ctx.seed, 3))
    # the snapshots wait on the host, out of the card's memory peak
    s.params0 = [p.detach().to("cpu", copy=True) for p in model.parameters()]
    s.losses = []
    torch.manual_seed(seed_words(ctx.seed, 4))        # dropout
    for i in range(CHECKED_STEPS):
        s.losses.append(one_step(ctx, s, i))
        if i == 0:
            s.trace1 = [x.to("cpu", copy=True) for x in opt.state["trace"]]
    s.params3 = [p.detach().to("cpu", copy=True) for p in model.parameters()]
    s.next, s.failed = CHECKED_STEPS, 0
    return s


def one_step(ctx, s: State, index: int) -> float:
    """The window's call: a host batch to the card, one step, the loss
    back on the host."""
    batch = s.to_device(s.host[index % len(s.host)], ctx.device)
    return float(s.step(batch, s.gen)["loss"])


def window(ctx, s: State, seconds: float) -> Dict:
    records, steps = [], 0
    t0 = time.perf_counter()
    while True:
        loss = one_step(ctx, s, s.next)
        i = s.next % len(s.host)
        records.append({"samples": s.host[i]["inputs_length"].tolist(),
                        "labels": s.host[i]["targets_length"].tolist()})
        s.next += 1
        steps += 1
        s.failed += not np.isfinite(loss)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    return {"records": records, "attempted": steps, "failed": s.failed,
            "end_to_end": {"train_audio_x": steps * s.mix.audio_seconds() / elapsed}}


def leaf_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor],
              keep: List[bool]) -> torch.Tensor:
    """Each counted leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's (0 for the others)."""
    pn = torch.stack([x.double().norm().cpu() for x in prog])
    rn = torch.stack([x.double().norm().cpu() for x in ref])
    kept = torch.tensor(keep)
    median = rn[kept].median()
    return torch.where(kept, (pn - rn).abs() / torch.maximum(rn, median), 0.0)


def reference_steps(ctx, pool, names):
    """The plain reference's first steps on the run's batches, weights,
    SpecAugment and dropout streams: (losses, the first step's clipped
    gradients, the parameters' change, which leaves count)."""
    from benchmark import weights
    from benchmark.reference.train import Batch, loss_and_grads, sgd_step
    cfg = ctx.cfg
    spec = weights.spec(cfg["model"])
    w = weights.make(spec, seed_words(ctx.seed, 2), ctx.device)
    gen = torch.Generator().manual_seed(seed_words(ctx.seed, 3))
    band = None
    if cfg["encoder"] == "banded":
        band = (cfg["model"]["enc"]["left_context"], cfg["model"]["enc"]["right_context"])
    optim = cfg["optim"]
    torch.manual_seed(seed_words(ctx.seed, 4))
    trace, losses = {}, []
    for i, utts in enumerate(pool):
        batch = Batch([u.wave for u in utts], [u.labels for u in utts],
                      cfg["data"]["max_target_length"])
        loss, grads, _ = loss_and_grads(w, cfg, batch, gen, cfg["model"]["dropout"], band,
                                        bool(ctx.traffic["specaug"]), pruned_of(ctx.traffic))
        losses.append(float(loss))
        clipped = sgd_step(w, grads, trace, optim["lr"], optim["momentum"],
                           cfg["training"]["max_grad_norm"])
        if i == 0:
            # leaves whose gradient is nought to rounding move by round-off
            # alone: they do not count
            raw = torch.stack([grads[n].double().norm().cpu() for n in names])
            keep = (raw >= 1e-3 * raw.median()).tolist()
            first = [clipped[n].cpu() for n in names]
        del grads, clipped
    w0 = weights.make(spec, seed_words(ctx.seed, 2), ctx.device)
    change = [(w[n] - w0[n]).cpu() for n in names]
    return losses, first, change, keep


def readings(losses, first, change, ref, names=None) -> Dict[str, float]:
    """The three numbers compared; with ``names``, the worst leaf of each
    leaf-wise number on standard error."""
    ref_losses, ref_first, ref_change, keep = ref
    out = {"loss": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))}
    for key, prog, refs in (("grad1", first, ref_first), ("change3", change, ref_change)):
        gaps = leaf_gaps(prog, refs, keep)
        out[key] = float(gaps.max())
        if names is not None:
            print(f"{key}: worst leaf {names[int(gaps.argmax())]}", file=sys.stderr)
    return out


def check(ctx, s: State, out: Dict):
    names, pool = s.names, s.pool[:CHECKED_STEPS]
    mine = (s.losses, s.trace1, [b - a for a, b in zip(s.params0, s.params3)])
    del s.model, s.opt, s.step, s.trace1, s.params0, s.params3
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(ctx, pool, names)
    got = readings(*mine, ref, names)
    if getattr(ctx, "control", False):
        from benchmark.harness import tf32
        with tf32():
            control = reference_steps(ctx, pool, names)
        ctx.readings = readings(*control[:3], ref)
    limits = ctx.workload["limits"]
    return [(name, got[name], limits[name]) for name in ("loss", "grad1", "change3")]
