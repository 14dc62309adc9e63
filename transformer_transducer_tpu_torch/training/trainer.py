"""Training orchestration on one device (port of ``training/trainer.py``).

Flow (reference ``train.py:142-265``): config -> vocab -> datasets -> model
-> optimizer -> (optional checkpoint load / ``continue`` mode) -> per epoch
[train epoch -> LR decay from ``begin_to_adjust_lr`` (early stop at
lr < 1e-6) -> save the split checkpoint -> greedy-decode evaluation with CER
and a decode dump].  Per-step loss/lr/grad-norm and per-epoch CER go to the
log and, with ``training.visualization``, to ``metrics.jsonl``.

Mid-epoch ``step_*`` checkpoints (``training.save_every_steps``) carry the
data position and the random generators, so ``-mode continue`` resumes
step for step.  ``-mode continue``, ``training.load_model``,
``load_encoder`` and ``load_decoder`` also take the JAX package's
checkpoint directories (msgpack): the weights, the optimizer state and the
counters carry over; a JAX step checkpoint's random key does not, so
dropout and SpecAugment then draw from ``training.seed``.  With
``data.on_device_features`` the loaders ship raw waves and the log-mel
runs on the card inside the step and the evaluation.

Both model families: an espnet-schema config (a ``model.mask`` block;
``apps/train_esptt.py``) builds ``models/espnet_variant.py``'s model, whose
step encodes with the input lengths and runs the loss over
``encoded_lengths``, and whose evaluation decodes from sos over those
lengths; ``flash``, ``banded`` and ``remat`` apply to the native family
only and are ignored for it, as the JAX trainer ignores them.

``compute_dtype=torch.bfloat16`` (``--bf16``) trains with bf16 compute over
float32 parameters: the model (either family) and both losses cast where
the JAX package casts, the optimizer and the checkpoints hold float32, and
the evaluation decodes with the bf16 encoder and joint (the KV label cache
runs in float32, as JAX's).  ``remat`` (``--remat``) recomputes each encoder
layer in the backward.

``fit(profile_dir=...)`` (``--profile DIR``) trains the run's first epoch
under ``torch.profiler`` (CPU activity, and the card's with a CUDA device)
and writes TensorBoard's ``*.pt.trace.json`` to ``DIR``
(:meth:`Trainer.profile_epoch`).  The evaluation's CER runs on the token
ids, so it takes the native edit distance (``utils/metrics.py``); the
vocabulary maps ids to symbols one to one, so it equals the CER of the
decoded text.

Data parallelism (``n_data``, ``parallel/mesh.py``): one process a data
rank, as ``torchrun`` starts them (the process group joined before the
trainer is built, ``apps/train.py``).  Every rank loads the same global
batch (same loader seed) and trains on its rows; the step averages the
gradients and the loss over the ranks.  ``n_data`` defaults, as in the
JAX trainer, to the largest divisor of the batch that is at most the world
size; ranks past it train nothing.  ``zero`` (``parallel.zero``) splits the
optimizer's moments over the data ranks (ZeRO-1, ``training/optim.py``).
Rank 0 alone writes the log file, the metrics, the decode dumps and the
checkpoints, which hold the moments whole (gathered by every rank), so a
run continues at any world size.  The evaluation runs over the ranks on
batches padded to ``data.batch_size`` (the padding rows dropped), so its
loss and CER are the single-process run's.

Tensor parallelism (``n_model``, JAX's ``model`` axis): the world is a
``(data, model)`` grid (``parallel/mesh.py``); each model group holds one
replica, narrowed by ``parallel/sharding.py::shard_model`` after the whole
weights are built (and loaded: a checkpoint is read whole and narrowed).
``n_data`` then defaults to the largest divisor of the batch that is at
most the world over ``n_model``.  Dropout and SpecAugment are seeded by the
data index, so the ranks of a model group draw the same masks on their
replicated activations.  Checkpoints hold the whole model and moments
(gathered by every rank), so a tensor-parallel run continues in one process
and the other way round.  The evaluation's loss runs sharded; its greedy
decoding runs on a gathered copy of the weights, made once an evaluation
(JAX decodes sharded; the CER is the same function).

Pipeline parallelism (``n_pipe``, ``pipe_micro``, or the config's
``parallel.n_pipe`` / ``parallel.pipe_micro``; the argument wins; JAX's
``pipe`` axis): the world is a ``(data, pipe)`` grid, the encoder's layers
split over the stages (``parallel/sharding.py::pipe_model``) and each step
runs JAX's GPipe schedule over ``pipe_micro`` microbatches (default ``2 *
n_pipe``; ``training/train_step.py``).  JAX's checks: ``n_pipe`` with
``n_model`` raises ``NotImplementedError``, encoder blocks that do not
divide over the stages or a batch that does not divide into the
microbatches raise ``ValueError``; ``n_data`` defaults to the largest
divisor of the batch and of its microbatch at most the world over
``n_pipe``.  ``--remat`` does not apply inside the stages (JAX's stage
layers keep flash and the compute dtype, not ``nn.remat``).  The stages'
dropout draws from a generator seeded by the data index (and the stage,
inside the schedule).  Checkpoints hold the whole model and moments in the
per-layer layout (gathered over the pipe group), so a pipelined run
continues in one process and the other way round.  The evaluation runs
the encoder through the pipeline; every stage gets its states and decodes
its data rank's rows.  The JAX package's sequence parallelism comes in a
later slice and raises ``NotImplementedError`` here.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from transformer_transducer_tpu_torch.data.dataset import AudioDataset
from transformer_transducer_tpu_torch.data.loader import DataLoader
from transformer_transducer_tpu_torch.decoding.greedy import greedy_decode, tokens_to_lists
from transformer_transducer_tpu_torch.models.espnet_variant import EspnetTransducer
from transformer_transducer_tpu_torch.models.factory import build_family
from transformer_transducer_tpu_torch.parallel import mesh as mesh_lib
from transformer_transducer_tpu_torch.parallel.sharding import (
    gather_model, gathered_state_dict, narrow_state_dict, pipe_model, pipe_plan,
    shard_model, tp_plan, zero_param_shardings)
from transformer_transducer_tpu_torch.parallel.pipeline import (
    encode_for_decoding as encode_pipelined_for_decoding, encoder_layers)
from transformer_transducer_tpu_torch.training import optim as optim_lib
from transformer_transducer_tpu_torch.training.train_step import (
    TrainStepConfig, batch_to_device, featurize, frame_lengths, make_eval_loss_step,
    make_train_step)
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.config import (
    Config, dump_config, stack_context, subsample_factor)
from transformer_transducer_tpu_torch.utils.device import resolve_device
from transformer_transducer_tpu_torch.utils.logging import MetricsWriter, init_logger
from transformer_transducer_tpu_torch.utils.metrics import batch_cer
from transformer_transducer_tpu_torch.utils.vocab import Vocabulary


class Trainer:
    def __init__(self, config: Config, mode: str = "retrain",
                 log_file: str = "train.log", exp_root: str = "egs",
                 flash: bool = False, banded: bool = False, device=None,
                 compute_dtype: torch.dtype = torch.float32, remat: bool = False,
                 n_data: Optional[int] = None, zero: Optional[bool] = None,
                 n_model: int = 1, n_pipe: Optional[int] = None,
                 pipe_micro: Optional[int] = None):
        self.device = resolve_device(mesh_lib.local_device(device))
        pcfg = config.parallel or Config()
        if (pcfg.n_seq or 1) > 1:
            raise mesh_lib.later("sequence parallelism (parallel.n_seq)")
        # parallel.zero (the argument wins): ZeRO-1, the optimizer's moments
        # split over the data ranks
        self.zero = bool(zero if zero is not None else pcfg.zero)
        # parallel.n_pipe / parallel.pipe_micro (the arguments win): the
        # encoder's layers in stages, pipe_micro microbatches a step
        self.n_pipe = int(n_pipe if n_pipe is not None else (pcfg.n_pipe or 1))
        self.pipe_micro = int(pipe_micro if pipe_micro is not None
                              else (pcfg.pipe_micro or 0)) or 2 * self.n_pipe
        batch = config.data.batch_size or 1
        n_model = int(n_model or 1)
        if self.n_pipe > 1:
            # JAX's checks (training/trainer.py:100-110); an espnet-schema
            # config (model.mask) counts its encoder blocks in num_blocks
            blocks = (config.model.enc.num_blocks if config.model.mask is not None
                      else config.model.enc.n_layer)
            if n_model > 1:
                raise NotImplementedError("n_pipe composes with the data axis only; "
                                          "set n_model=1")
            if blocks % self.n_pipe:
                raise ValueError(f"encoder blocks={blocks} must divide over "
                                 f"{self.n_pipe} pipeline stages")
            if batch % self.pipe_micro:
                raise ValueError(f"batch_size={batch} must divide into "
                                 f"{self.pipe_micro} microbatches (parallel.pipe_micro)")
        if n_data is None:
            n_data = mesh_lib.default_n_data(batch, n_model, self.n_pipe, self.pipe_micro)
        self.mesh = mesh_lib.make_mesh(n_data=n_data, n_model=n_model, n_pipe=self.n_pipe)
        if batch % self.mesh.n_data:
            raise ValueError(f"data.batch_size={batch} must divide over "
                             f"{self.mesh.n_data} data ranks")
        if self.n_pipe > 1 and (batch // self.pipe_micro) % self.mesh.n_data:
            raise ValueError(f"microbatch size {batch // self.pipe_micro} must divide "
                             f"over the {self.mesh.n_data}-way data axis")
        self.is_main = self.mesh.is_main
        self.config = config
        self.mode = mode
        self.exp_dir = os.path.join(exp_root, config.data.name or "exp",
                                    config.training.save_model or "model")
        os.makedirs(self.exp_dir, exist_ok=True)
        self.logger = init_logger(os.path.join(self.exp_dir, log_file)
                                  if self.is_main else None)
        if self.is_main:
            dump_config(config, os.path.join(self.exp_dir, "config.yaml"))
        else:
            self.logger.setLevel(logging.WARNING)   # rank 0 tells the run
        self.metrics = (MetricsWriter(self.exp_dir)
                        if config.training.visualization and self.is_main else None)
        self.logger.info("Mesh: %s, ZeRO-1 %s, rank %d", self.mesh.shape,
                         "on" if self.zero else "off", mesh_lib.world_rank())

        self.vocab = Vocabulary.from_file(config.data.vocab)
        self.logger.info("Loaded vocabulary: %d units", len(self.vocab))

        seed = config.training.seed or 1
        torch.manual_seed(seed)           # initial weights and dropout
        self.gen = torch.Generator().manual_seed(seed)   # SpecAugment stripes
        self.model = build_family(config, device=self.device, flash=flash,
                                  banded=banded, remat=remat,
                                  compute_dtype=compute_dtype).train()
        self._spread_dropout(seed)
        self.is_espnet = isinstance(self.model, EspnetTransducer)
        # the stages' dropout: seeded by the data index (the stage enters in
        # the schedule)
        self.pipe_gen = torch.Generator().manual_seed(self._pipe_seed(seed, 0))
        if self.is_espnet and (flash or banded):
            self.logger.info("--flash/--banded select the native family's "
                             "attention kernels; the espnet family ignores them")
        if self.is_espnet and remat:
            self.logger.info("--remat recomputes the native family's encoder "
                             "layers; the espnet family ignores it")
        if self.n_pipe > 1 and remat and not self.is_espnet:
            self.logger.info("--remat does not apply inside pipeline stages (JAX's "
                             "stage layers keep flash and the compute dtype, not remat)")
        self.logger.info("compute dtype %s over float32 parameters; encoder "
                         "remat %s", str(compute_dtype).replace("torch.", ""),
                         "on" if remat and not self.is_espnet and self.n_pipe == 1
                         else "off")
        n_total = sum(p.numel() for p in self.model.parameters())
        n_enc = sum(p.numel() for p in self.model.encoder.parameters())
        n_dec = sum(p.numel() for p in self.model.decoder.parameters())
        self.logger.info("# parameters: total %d | encoder %d | decoder %d | "
                         "joint %d", n_total, n_enc, n_dec, n_total - n_enc - n_dec)
        if self.mesh.active:
            # the whole weights built alike on every rank (one seed), then
            # this model rank's slices (none with one model rank); a
            # checkpoint is read whole and narrowed; a pipe stage keeps its
            # own encoder layers
            shard_model(self.model, self.mesh)
            pipe_model(self.model, self.mesh)
        if self.n_pipe > 1:
            self.logger.info("Pipeline: %d stages of %d encoder layers, %d microbatches a "
                             "step (bubble %.4f); %d parameters on this stage",
                             self.n_pipe, len(encoder_layers(self.model)) // self.n_pipe,
                             self.pipe_micro,
                             (self.n_pipe - 1) / (self.pipe_micro + self.n_pipe - 1),
                             sum(p.numel() for p in self.model.parameters()))

        # training.grad_accum_steps: the mean of K batches' gradients per
        # update (optax MultiSteps).  global_step (and --save-steps and the
        # nan-guard skip count) ticks per loader batch, the step schedule
        # per applied update.
        ga = int(config.training.grad_accum_steps or 1)
        zero_plan = None
        if self.zero and self.mesh.parallel:
            zero_plan = (self.mesh, zero_param_shardings(self.model, self.mesh))
        self.optimizer = optim_lib.build_optimizer(
            config.optim, list(self.model.parameters()),
            max_grad_norm=config.training.max_grad_norm, grad_accum_steps=ga,
            zero=zero_plan, tp=tp_plan(self.model), pipe=pipe_plan(self.model))
        if ga > 1:
            self.logger.info("Gradient accumulation: %d batches per update", ga)
        self.lr_ctl = optim_lib.LRController(
            lr=config.optim.lr, decay_ratio=config.optim.decay_ratio or 1.0,
            begin_to_adjust=config.optim.begin_to_adjust_lr or 0)
        self.start_epoch = 0
        self.global_step = 0
        self.save_every_steps = int(config.training.save_every_steps or 0)
        self._last_step_save = 0
        self._resume_batches = 0
        self._maybe_load()
        if self.mesh.parallel and self.mesh.active:
            # the replicas start from data index 0's weights (its rank in
            # this model and pipe index's data group)
            with torch.no_grad():
                for p in self.model.parameters():
                    if p.numel():
                        dist.broadcast(p, src=self.mesh.data_root,
                                       group=self.mesh.data_group)

        tcfg = config.training
        # data.on_device_features: the loaders ship raw padded waves and the
        # log-mel, stack and subsample run on the card in the train step and
        # the evaluation (ops/features.py::extract_batch_padded)
        dcfg = config.data
        self.frontend = None
        if dcfg.on_device_features:
            self.frontend = (dcfg.feature_dim or 128, *stack_context(dcfg),
                             subsample_factor(dcfg), int(dcfg.max_input_length), "eps")
        # training.loss_pruned_range: band width N > 0 selects the pruned
        # loss (ops/rnnt_loss_pruned.py), absent the full loss;
        # training.loss_simple_scale defaults to 0.25
        self.step_cfg = TrainStepConfig(
            frontend=self.frontend,
            specaug=True if tcfg.specaug is None else bool(tcfg.specaug),
            loss_remat=True if tcfg.loss_remat is None else bool(tcfg.loss_remat),
            loss_pruned_range=int(tcfg.loss_pruned_range) if tcfg.loss_pruned_range
            else None,
            loss_simple_scale=0.25 if tcfg.loss_simple_scale is None
            else float(tcfg.loss_simple_scale),
            nan_guard=bool(tcfg.nan_guard), pipe_micro=self.pipe_micro)
        self.max_skipped_steps = int(tcfg.max_skipped_steps or 25)
        self._consecutive_skips = 0
        self.total_skips = 0
        self.train_step = make_train_step(self.model, self.optimizer, self.step_cfg,
                                          mesh=self.mesh, generator=self.pipe_gen)
        # training.steps_per_call = K: K single steps between the step
        # checkpoint checks (the JAX package scans K updates in one program)
        self.steps_per_call = int(tcfg.steps_per_call or 1)
        self.eval_loss_step = make_eval_loss_step(self.model, self.step_cfg,
                                                  mesh=self.mesh)

    # ------------------------------------------------------------------
    def _pipe_seed(self, seed: int, step: int) -> int:
        """The stages' dropout generator's seed: the data index's, moving on
        with the step (on a resume)."""
        return 1_000_003 * seed + step * self.mesh.n_data + self.mesh.data_rank

    def _rng_state(self):
        state = {"specaug": self.gen.get_state(), "torch": torch.get_rng_state()}
        if self.device.type == "cuda":
            state["cuda"] = torch.cuda.get_rng_state(self.device)
        return state

    def _spread_dropout(self, seed: int) -> None:
        # dropout differs from data rank to data rank: data index r > 0
        # reseeds the torch and CUDA generators with seed + r; index 0 draws
        # as one process.  The ranks of a model group draw alike, so their
        # replicated activations stay equal.
        if self.mesh.data_rank:
            torch.manual_seed(seed + self.mesh.data_rank)

    def _set_rng_state(self, state) -> None:
        # generator states are CPU byte tensors, wherever the checkpoint
        # was mapped
        self.gen.set_state(state["specaug"].cpu())
        torch.set_rng_state(state["torch"].cpu())
        if "cuda" in state and self.device.type == "cuda":
            torch.cuda.set_rng_state(state["cuda"].cpu(), self.device)
        # the state is rank 0's: the other data ranks spread again, from a
        # seed that moves on with the step (seed + step * n_data + data rank)
        self._spread_dropout((self.config.training.seed or 1)
                             + self.global_step * self.mesh.n_data)
        self.pipe_gen.manual_seed(self._pipe_seed(self.config.training.seed or 1,
                                                  self.global_step))

    def _load_component(self, comp: str, state) -> None:
        """A whole component's ``state``, narrowed to a sharded model."""
        getattr(self.model, comp).load_state_dict(
            narrow_state_dict(self.model, state, comp + "."))

    def _load_components(self, state, comps) -> None:
        for comp in comps:
            self._load_component(comp, state[comp])

    def _maybe_load(self):
        tcfg = self.config.training
        if self.mode == "continue":
            path = ckpt_lib.latest_checkpoint(self.exp_dir) or tcfg.load_model
            if not path:
                raise FileNotFoundError("continue mode but no checkpoint found")
            names = [n for n, _ in self.model.named_parameters()]
            state = ckpt_lib.load_checkpoint(path, self.device, param_names=names)
            self._load_components(state, ckpt_lib.COMPONENTS)
            if state.get("optimizer") is not None:
                self.optimizer.load_state_dict(state["optimizer"])
            self.start_epoch = state.get("epoch", 0) + 1
            self.global_step = state.get("step", 0)
            self.lr_ctl.lr = state.get("lr", self.lr_ctl.lr)
            if "mid_epoch" in state:   # step_* checkpoint: resume in-epoch
                self.start_epoch = int(state["mid_epoch"])
                self._resume_batches = int(state.get("batches_done", 0))
                if isinstance(state.get("rng"), dict):
                    self._set_rng_state(state["rng"])
                else:
                    self.logger.info(
                        "%s holds a JAX random key, which torch cannot use: "
                        "dropout and SpecAugment are re-seeded from "
                        "training.seed (%d)", path, self.config.training.seed or 1)
                self._last_step_save = self.global_step
                self.logger.info(
                    "Continue mid-epoch from %s (epoch %d, batch %d, step %d)",
                    path, self.start_epoch, self._resume_batches, self.global_step)
            else:
                self.logger.info("Continue from %s (epoch %d, step %d)",
                                 path, self.start_epoch, self.global_step)
        elif tcfg.load_model:
            state = ckpt_lib.load_checkpoint(tcfg.load_model, self.device)
            self._load_components(state, ckpt_lib.COMPONENTS)
            self.logger.info("Loaded model from %s", tcfg.load_model)
        else:
            if tcfg.load_encoder:
                self._load_component("encoder", ckpt_lib.load_component(
                    tcfg.load_encoder, "encoder", self.device))
                self.logger.info("Loaded encoder from %s", tcfg.load_encoder)
            if tcfg.load_decoder:
                self._load_component("decoder", ckpt_lib.load_component(
                    tcfg.load_decoder, "decoder", self.device))
                self.logger.info("Loaded decoder from %s", tcfg.load_decoder)

    # ------------------------------------------------------------------
    def make_loaders(self, augment: bool = False):
        dcfg = self.config.data
        odf = bool(dcfg.on_device_features)
        train_ds = AudioDataset(dcfg, "train", self.vocab, augment=augment,
                                on_device_features=odf)
        dev_ds = AudioDataset(dcfg, "dev", self.vocab, on_device_features=odf)
        shuffle = bool(dcfg.shuffle)
        if dcfg.short_first and shuffle:
            self.logger.warning("data.short_first overrides data.shuffle: "
                                "training keeps the short-first curriculum "
                                "order")
            shuffle = False
        train = DataLoader(train_ds, dcfg.batch_size, shuffle=shuffle,
                           seed=self.config.training.seed or 1)
        dev = DataLoader(dev_ds, dcfg.batch_size, shuffle=False, drop_last=False)
        return train, dev

    def _current_lr(self) -> float:
        """The rate in effect: the optimizer's under a step schedule, else
        the epoch-level controller's."""
        if self.config.optim.schedule is not None:
            return self.optimizer.learning_rate
        return self.lr_ctl.lr

    def _record_step(self, epoch, loss, grad_norm, total_loss, steps, t0):
        show = self.config.training.show_interval or 10
        showing = self.global_step % show == 0
        if self.metrics is None and not showing:
            return
        lr = self._current_lr()
        if self.metrics is not None:
            self.metrics.add_scalar("train_loss", loss, self.global_step)
            self.metrics.add_scalar("learn_rate", lr, self.global_step)
        if showing:
            dt = time.perf_counter() - t0
            self.logger.info(
                "-Training-Epoch:%d, Step:%d, lr:%.6f, GradNorm:%.4f, "
                "Loss:%.5f, AvgLoss:%.5f, %.2f steps/s", epoch,
                self.global_step, lr, grad_norm, loss, total_loss / steps,
                steps / dt)

    def _note_skips(self, skips) -> None:
        """Warn for each skipped update; fail after ``max_skipped_steps``
        consecutive ones (a stream of non-finite losses is divergence)."""
        for s in skips:
            if int(s):
                self._consecutive_skips += 1
                self.total_skips += 1
                self.logger.warning(
                    "non-finite loss/grad at step %d — update skipped "
                    "(%d consecutive)", self.global_step,
                    self._consecutive_skips)
                if self._consecutive_skips >= self.max_skipped_steps:
                    raise RuntimeError(
                        f"{self._consecutive_skips} consecutive non-finite "
                        f"training steps (training.max_skipped_steps="
                        f"{self.max_skipped_steps}): training has diverged")
            else:
                self._consecutive_skips = 0

    def train_epoch(self, epoch: int, loader) -> float:
        total_loss, steps = 0.0, 0
        t0 = time.perf_counter()
        k = self.steps_per_call
        # the loader re-derives this epoch's order (seed + epoch) and skips
        # the batches a step_* checkpoint already consumed
        loader.epoch = epoch
        skip = self._resume_batches
        self._resume_batches = 0
        loader.start_batch = skip

        def maybe_step_save():
            if (self.save_every_steps and self.global_step -
                    self._last_step_save >= self.save_every_steps):
                self.save_step(epoch, skip + steps)

        def run_single(batch):
            nonlocal total_loss, steps
            batch = mesh_lib.shard_batch(batch, self.mesh)
            m = self.train_step(batch_to_device(batch, self.device), self.gen)
            self.global_step += 1
            steps += 1
            loss = float(m["loss"])
            total_loss += loss
            self._record_step(epoch, loss, float(m["grad_norm"]), total_loss,
                              steps, t0)
            if "skipped" in m:
                self._note_skips([m["skipped"]])

        pending = []
        for batch in loader:
            pending.append(batch)
            if len(pending) == k:
                for b in pending:
                    run_single(b)
                pending = []
                maybe_step_save()    # at group granularity, as the scanned
                                     # K updates of the JAX package
        for batch in pending:        # the tail: single steps
            run_single(batch)
            maybe_step_save()
        avg = total_loss / max(steps, 1)
        self.logger.info("-Training-Epoch:%d done, AvgLoss: %.5f", epoch, avg)
        return avg

    def evaluate(self, epoch: int, loader, max_batches: Optional[int] = None,
                 compute_loss: bool = True) -> float:
        """Eval loss, batched greedy decoding of the full-context encoder
        (an espnet encoder under its own band, with the lengths) and CER;
        the transcripts go to ``decode_{epoch}.txt``.  Over several data
        ranks each decodes its rows of the batch, padded to
        ``data.batch_size``, and every rank gets every row's result."""
        total_dist, total_words = 0, 0
        total_loss, loss_utts = 0.0, 0
        dump_path = os.path.join(self.exp_dir, f"decode_{epoch}.txt")
        max_tokens = self.config.data.max_target_length + 1
        # padded to data.batch_size over data ranks or microbatches
        parallel = self.mesh.parallel or self.mesh.pipelined
        # greedy decoding on whole weights: a gathered copy under tensor
        # parallelism (every rank gathers), the model itself otherwise
        decoder = (gather_model(copy.deepcopy(self.model)).eval()
                   if self.model.tp is not None else self.model)
        pipelined = self.mesh.pipelined
        with open(dump_path if self.is_main else os.devnull, "w", encoding="utf-8") as dump:
            for bi, batch in enumerate(loader):
                if max_batches is not None and bi >= max_batches:
                    break
                valid = len(batch["inputs"])
                if parallel:
                    batch, valid = mesh_lib.pad_rows(batch, self.config.data.batch_size or 1)
                dev_batch = batch_to_device(batch, self.device)
                if compute_loss:
                    losses = self.eval_loss_step(dev_batch)[:valid]
                    total_loss += float(losses.sum())
                    loss_utts += len(losses)
                decoder.eval()
                mine = mesh_lib.shard_batch(dev_batch, self.mesh)
                with torch.no_grad():
                    if pipelined:
                        # the encoder through the stages; every stage gets
                        # its states
                        enc, t_len = self._encode_pipelined(mine)
                    else:
                        inputs, t_len = featurize(mine, self.frontend)
                        enc, t_len = decoder.encode_for_decoding(inputs, t_len)
                tokens, counts = greedy_decode(decoder, enc, t_len,
                                               max_tokens=max_tokens)
                tokens, counts = (mesh_lib.gather_rows(x, self.mesh)[:valid]
                                  for x in (tokens, counts))
                preds = tokens_to_lists(tokens.cpu().numpy(), counts.cpu().numpy())
                refs = [list(batch["targets"][i][:batch["targets_length"][i]])
                        for i in range(len(preds))]
                pred_txt = [self.vocab.decode(p) for p in preds]
                ref_txt = [self.vocab.decode(r) for r in refs]
                dist, words = batch_cer(preds, refs)
                total_dist += dist
                total_words += words
                for p, r in zip(pred_txt, ref_txt):
                    dump.write("Transcripts:" + "".join(r) + "\n")
                    dump.write("---Predicts:" + "".join(p) + "\n")
        self.model.train()
        cer = 100.0 * total_dist / max(total_words, 1)
        avg_loss = total_loss / max(loss_utts, 1)
        self.logger.info("-Validation-Epoch:%d, AverageLoss: %.5f, "
                         "CER: %.5f %%", epoch, avg_loss, cer)
        if self.metrics is not None:
            self.metrics.add_scalar("cer", cer, epoch)
            if loss_utts:
                self.metrics.add_scalar("eval_loss", avg_loss, epoch)
        return cer

    def _encode_pipelined(self, batch):
        """``(enc, t_len)`` of this data rank's rows through the pipeline,
        on every stage (stage 0 featurizes, the others take the lengths)."""
        rows = batch["targets"].shape[0]
        if self.mesh.first_stage:
            inputs, t_len = featurize(batch, self.frontend)
            t_in = inputs.shape[1]
        else:
            inputs = None
            t_in, t_len = frame_lengths(batch, self.frontend)
        return encode_pipelined_for_decoding(self.model, inputs, t_len, self.mesh,
                                             self.pipe_micro, rows=rows, t_in=t_in)

    def _whole_model(self):
        """The model, or under tensor or pipeline parallelism its whole
        state dict (a collective: every rank gathers)."""
        if self.model.tp is not None or getattr(self.model, "pipe", None) is not None:
            return gathered_state_dict(self.model)
        return self.model

    def save(self, epoch: int):
        path = os.path.join(self.exp_dir, f"epoch_{epoch}")
        # every rank gathers (a ZeRO optimizer's moments, a sharded model);
        # rank 0 writes
        opt_state = self.optimizer.state_dict()
        model = self._whole_model()
        if not self.is_main:
            return
        ckpt_lib.save_checkpoint(path, model, opt_state, epoch=epoch,
                                 step=self.global_step,
                                 extra={"lr": self.lr_ctl.lr})
        ckpt_lib.prune_step_checkpoints(self.exp_dir)
        self.logger.info("Epoch %d checkpoint saved to %s", epoch, path)

    def save_step(self, epoch: int, batches_done: int):
        """Mid-epoch checkpoint ``step_<global_step>``: weights, optimizer
        state, the data position and the random generators; only the newest
        one is kept."""
        path = os.path.join(self.exp_dir, f"step_{self.global_step}")
        opt_state = self.optimizer.state_dict()     # every rank, as in save
        model = self._whole_model()
        self._last_step_save = self.global_step
        if not self.is_main:
            return
        ckpt_lib.save_checkpoint(
            path, model, opt_state,
            # "epoch": the last completed epoch, as in epoch_* checkpoints
            epoch=epoch - 1, step=self.global_step,
            extra={"lr": self.lr_ctl.lr, "mid_epoch": epoch,
                   "batches_done": int(batches_done)},
            rng=self._rng_state())
        ckpt_lib.prune_step_checkpoints(self.exp_dir, keep=path)
        self.logger.info("Step checkpoint saved to %s (epoch %d, batch %d)",
                         path, epoch, batches_done)

    def profile_epoch(self, epoch: int, loader, trace_dir: str) -> float:
        """One training epoch under ``torch.profiler``: CPU activity, and
        CUDA activity on a CUDA device, written when the epoch ends as
        TensorBoard's ``*.pt.trace.json`` to ``trace_dir``.  A profiler that
        cannot start or finish logs a warning and the epoch stands, as in
        the JAX package; a failure of the training itself propagates."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=activities,
                           on_trace_ready=tensorboard_trace_handler(trace_dir))
            prof.__enter__()
        except Exception as e:  # a build or a host without profiler support
            self.logger.warning("profiler unavailable (%s); training unprofiled", e)
            return self.train_epoch(epoch, loader)
        try:
            # a training failure is real: it propagates, never masked as a
            # profiling warning
            avg = self.train_epoch(epoch, loader)
        finally:
            try:
                prof.__exit__(None, None, None)
                self.logger.info("profiler trace written to %s", trace_dir)
            except Exception as e:  # teardown only: the epoch is valid
                self.logger.warning("profiler teardown failed (%s); continuing "
                                    "without a trace", e)
        return avg

    def fit(self, epochs: Optional[int] = None, augment: bool = False,
            eval_batches: Optional[int] = None,
            profile_dir: Optional[str] = None):
        """Train from ``start_epoch`` to ``epochs``; with ``profile_dir``
        the first of these epochs runs under :meth:`profile_epoch`."""
        epochs = epochs or self.config.training.epochs
        if not self.mesh.active:
            self.logger.warning("rank %d is past the data axis (%d ranks): it "
                                "trains nothing", mesh_lib.world_rank(), self.mesh.n_data)
            return
        train_loader, dev_loader = self.make_loaders(augment=augment)
        for epoch in range(self.start_epoch, epochs):
            if profile_dir and epoch == self.start_epoch:
                self.profile_epoch(epoch, train_loader, profile_dir)
            else:
                self.train_epoch(epoch, train_loader)
            # decay before save (the checkpoint carries the rate the next
            # epoch trains at); save before evaluate (an evaluation failure
            # must not lose the epoch)
            stop = False
            if self.config.optim.schedule is None:
                if self.lr_ctl.maybe_decay(epoch):
                    self.optimizer.learning_rate = self.lr_ctl.lr
                else:
                    stop = True
            self.save(epoch)
            if self.config.training.eval_or_not:
                self.evaluate(epoch, dev_loader, max_batches=eval_batches)
            if stop:
                self.logger.info("The learning rate is too low to train.")
                break
        self.logger.info("The training process is OVER!")
