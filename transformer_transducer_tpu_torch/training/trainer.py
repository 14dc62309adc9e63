"""Training orchestration on one device (port of ``training/trainer.py``).

Flow (reference ``train.py:142-265``): config -> vocab -> datasets -> model
-> optimizer -> (optional checkpoint load / ``continue`` mode) -> per epoch
[train epoch -> LR decay from ``begin_to_adjust_lr`` (early stop at
lr < 1e-6) -> save the split checkpoint -> greedy-decode evaluation with CER
and a decode dump].  Per-step loss/lr/grad-norm and per-epoch CER go to the
log and, with ``training.visualization``, to ``metrics.jsonl``.

Mid-epoch ``step_*`` checkpoints (``training.save_every_steps``) carry the
data position and the random generators, so ``-mode continue`` resumes
step for step.  The JAX package's mesh, pipeline, sequence-parallel and
ZeRO paths, the espnet family and the profiler come in later slices and
raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from transformer_transducer_tpu_torch.data.dataset import AudioDataset
from transformer_transducer_tpu_torch.data.loader import DataLoader
from transformer_transducer_tpu_torch.decoding.greedy import (
    greedy_decode, tokens_to_lists)
from transformer_transducer_tpu_torch.models.transducer import build_transducer
from transformer_transducer_tpu_torch.training import optim as optim_lib
from transformer_transducer_tpu_torch.training.train_step import (
    TrainStepConfig, batch_to_device, make_eval_loss_step, make_train_step)
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.config import Config, dump_config
from transformer_transducer_tpu_torch.utils.device import resolve_device
from transformer_transducer_tpu_torch.utils.logging import MetricsWriter, init_logger
from transformer_transducer_tpu_torch.utils.metrics import batch_cer
from transformer_transducer_tpu_torch.utils.vocab import Vocabulary


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is ported in a later slice of the "
                               "PyTorch port")


class Trainer:
    def __init__(self, config: Config, mode: str = "retrain",
                 log_file: str = "train.log", exp_root: str = "egs",
                 flash: bool = False, banded: bool = False, device=None):
        self.device = resolve_device(device)
        if config.model.mask is not None:
            raise _later("the espnet family (models/espnet_variant.py)")
        pcfg = config.parallel or Config()
        if (pcfg.n_pipe or 1) > 1 or (pcfg.n_seq or 1) > 1 or pcfg.zero:
            raise _later("parallel training (parallel/)")
        if config.training.loss_pruned_range:
            raise _later("the pruned loss (ops/rnnt_loss_pruned.py)")
        self.config = config
        self.mode = mode
        self.exp_dir = os.path.join(exp_root, config.data.name or "exp",
                                    config.training.save_model or "model")
        os.makedirs(self.exp_dir, exist_ok=True)
        self.logger = init_logger(os.path.join(self.exp_dir, log_file))
        dump_config(config, os.path.join(self.exp_dir, "config.yaml"))
        self.metrics = (MetricsWriter(self.exp_dir)
                        if config.training.visualization else None)

        self.vocab = Vocabulary.from_file(config.data.vocab)
        self.logger.info("Loaded vocabulary: %d units", len(self.vocab))

        seed = config.training.seed or 1
        torch.manual_seed(seed)           # initial weights and dropout
        self.gen = torch.Generator().manual_seed(seed)   # SpecAugment stripes
        self.model = build_transducer(config.model, flash=flash,
                                      device=self.device, banded=banded).train()
        n_total = sum(p.numel() for p in self.model.parameters())
        n_enc = sum(p.numel() for p in self.model.encoder.parameters())
        n_dec = sum(p.numel() for p in self.model.decoder.parameters())
        self.logger.info("# parameters: total %d | encoder %d | decoder %d | "
                         "joint %d", n_total, n_enc, n_dec, n_total - n_enc - n_dec)

        # training.grad_accum_steps: the mean of K batches' gradients per
        # update (optax MultiSteps).  global_step (and --save-steps and the
        # nan-guard skip count) ticks per loader batch, the step schedule
        # per applied update.
        ga = int(config.training.grad_accum_steps or 1)
        self.optimizer = optim_lib.build_optimizer(
            config.optim, list(self.model.parameters()),
            max_grad_norm=config.training.max_grad_norm, grad_accum_steps=ga)
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

        tcfg = config.training
        self.step_cfg = TrainStepConfig(
            specaug=True if tcfg.specaug is None else bool(tcfg.specaug),
            loss_remat=True if tcfg.loss_remat is None else bool(tcfg.loss_remat),
            nan_guard=bool(tcfg.nan_guard))
        self.max_skipped_steps = int(tcfg.max_skipped_steps or 25)
        self._consecutive_skips = 0
        self.total_skips = 0
        self.train_step = make_train_step(self.model, self.optimizer, self.step_cfg)
        # training.steps_per_call = K: K single steps between the step
        # checkpoint checks (the JAX package scans K updates in one program)
        self.steps_per_call = int(tcfg.steps_per_call or 1)
        self.eval_loss_step = make_eval_loss_step(self.model, self.step_cfg)

    # ------------------------------------------------------------------
    def _rng_state(self):
        state = {"specaug": self.gen.get_state(), "torch": torch.get_rng_state()}
        if self.device.type == "cuda":
            state["cuda"] = torch.cuda.get_rng_state(self.device)
        return state

    def _set_rng_state(self, state) -> None:
        # generator states are CPU byte tensors, wherever the checkpoint
        # was mapped
        self.gen.set_state(state["specaug"].cpu())
        torch.set_rng_state(state["torch"].cpu())
        if "cuda" in state and self.device.type == "cuda":
            torch.cuda.set_rng_state(state["cuda"].cpu(), self.device)

    def _load_components(self, state, comps) -> None:
        for comp in comps:
            getattr(self.model, comp).load_state_dict(state[comp])

    def _maybe_load(self):
        tcfg = self.config.training
        if self.mode == "continue":
            path = ckpt_lib.latest_checkpoint(self.exp_dir) or tcfg.load_model
            if not path:
                raise FileNotFoundError("continue mode but no checkpoint found")
            state = ckpt_lib.load_checkpoint(path, self.device)
            self._load_components(state, ckpt_lib.COMPONENTS)
            if state.get("optimizer") is not None:
                self.optimizer.load_state_dict(state["optimizer"])
            self.start_epoch = state.get("epoch", 0) + 1
            self.global_step = state.get("step", 0)
            self.lr_ctl.lr = state.get("lr", self.lr_ctl.lr)
            if "mid_epoch" in state:   # step_* checkpoint: resume in-epoch
                self.start_epoch = int(state["mid_epoch"])
                self._resume_batches = int(state.get("batches_done", 0))
                self._set_rng_state(state["rng"])
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
                self.model.encoder.load_state_dict(ckpt_lib.load_component(
                    tcfg.load_encoder, "encoder", self.device))
                self.logger.info("Loaded encoder from %s", tcfg.load_encoder)
            if tcfg.load_decoder:
                self.model.decoder.load_state_dict(ckpt_lib.load_component(
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
        and CER; the transcripts go to ``decode_{epoch}.txt``."""
        total_dist, total_words = 0, 0
        total_loss, loss_utts = 0.0, 0
        dump_path = os.path.join(self.exp_dir, f"decode_{epoch}.txt")
        max_tokens = self.config.data.max_target_length + 1
        with open(dump_path, "w", encoding="utf-8") as dump:
            for bi, batch in enumerate(loader):
                if max_batches is not None and bi >= max_batches:
                    break
                dev_batch = batch_to_device(batch, self.device)
                if compute_loss:
                    losses = self.eval_loss_step(dev_batch)
                    total_loss += float(losses.sum())
                    loss_utts += len(losses)
                self.model.eval()
                with torch.no_grad():
                    enc = self.model.encode(dev_batch["inputs"])
                tokens, counts = greedy_decode(self.model, enc,
                                               dev_batch["inputs_length"],
                                               max_tokens=max_tokens)
                preds = tokens_to_lists(tokens.cpu().numpy(), counts.cpu().numpy())
                refs = [list(batch["targets"][i][:batch["targets_length"][i]])
                        for i in range(len(preds))]
                pred_txt = [self.vocab.decode(p) for p in preds]
                ref_txt = [self.vocab.decode(r) for r in refs]
                dist, words = batch_cer(pred_txt, ref_txt)
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

    def save(self, epoch: int):
        path = os.path.join(self.exp_dir, f"epoch_{epoch}")
        ckpt_lib.save_checkpoint(path, self.model, self.optimizer, epoch=epoch,
                                 step=self.global_step,
                                 extra={"lr": self.lr_ctl.lr})
        ckpt_lib.prune_step_checkpoints(self.exp_dir)
        self.logger.info("Epoch %d checkpoint saved to %s", epoch, path)

    def save_step(self, epoch: int, batches_done: int):
        """Mid-epoch checkpoint ``step_<global_step>``: weights, optimizer
        state, the data position and the random generators; only the newest
        one is kept."""
        path = os.path.join(self.exp_dir, f"step_{self.global_step}")
        ckpt_lib.save_checkpoint(
            path, self.model, self.optimizer,
            # "epoch": the last completed epoch, as in epoch_* checkpoints
            epoch=epoch - 1, step=self.global_step,
            extra={"lr": self.lr_ctl.lr, "mid_epoch": epoch,
                   "batches_done": int(batches_done)},
            rng=self._rng_state())
        ckpt_lib.prune_step_checkpoints(self.exp_dir, keep=path)
        self._last_step_save = self.global_step
        self.logger.info("Step checkpoint saved to %s (epoch %d, batch %d)",
                         path, epoch, batches_done)

    def fit(self, epochs: Optional[int] = None, augment: bool = False,
            eval_batches: Optional[int] = None,
            profile_dir: Optional[str] = None):
        if profile_dir:
            raise _later("the profiled epoch (--profile)")
        epochs = epochs or self.config.training.epochs
        train_loader, dev_loader = self.make_loaders(augment=augment)
        for epoch in range(self.start_epoch, epochs):
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
