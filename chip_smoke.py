#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. the device: name, power limit, torch and nvcc versions;
2. build the port's CUDA kernels from ``transformer_transducer_tpu_torch/
   csrc`` (timed);
3. each kernel against its plain PyTorch version on the same CUDA inputs
   (atol 1e-4, rtol 1e-4), at the main path's shapes and a sweep around
   them;
4. the slice at full width: ``configs/joint_streaming.yaml`` (18 layers,
   d_model 512, V 6485) with seeded random weights, 8 synthetic utterances
   of 60-410 frames through the host frontend and batched greedy
   ``recognize`` — once under the streaming band (banded kernel), once
   full-context (flash kernel) — with each kernel's launch count read around
   that run; then the same through the plain versions, comparing encoder
   states (1e-3 after 18 layers) and tokens;
5. timings (medians after warm-up; CUDA events for device work, the host
   clock around synchronised calls): each kernel, its plain version, its
   bound, the end-to-end ``recognize``, and that split into the encoder and
   the greedy loop, with the device's idle share from ``torch.profiler``;
6. training at full width: the same config with dropout 0, a batch of 4
   utterances (60-410 frames, 5-42 targets), 3 SGD steps (momentum 0.9,
   clip 200) with ``flash=True`` and then ``banded=True``, each with the
   launch counts read around every step (18 attention forward and 18
   backward launches, 1 alpha and 1 beta sweep), then the same steps through
   the plain versions: losses within 1e-4 and step 1's gradient norm within
   1e-3, relative;
7. the training entry point: ``apps/train.py --flash`` on a synthetic corpus
   (16 train, 8 dev utterances, a 6485-symbol vocabulary) for one epoch,
   then ``-mode continue`` for a second: two checkpoints, decode dumps and a
   finite CER;
8. training timings: the new kernels against their plain versions and
   bounds, and the flagship train step (config dropout 0.5) for
   ``--flash``, ``--banded`` and dense attention, end to end and split into
   encoder forward, loss forward, backward and optimizer, with the device's
   idle share and peak memory.

Kernel checks in phase 3: each forward against its plain version (atol
1e-4, rtol 1e-4); the attention backward against autograd through the
plain version (atol 1e-4 * max|ref| + 1e-5, rtol 1e-4: the shared sums are
fp32 atomics in a varying order, and where a gradient is 0 in exact
arithmetic, as every softmax gradient at T = 1, only rounding is left); the
lattice sweeps against the eager scans (rtol 1e-5, atol 1e-3: log-alphas
reach thousands).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "transformer_transducer_tpu_torch"

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): HBM
# bytes/s and float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

B, H, DH = 8, 8, 64
T_MAIN, BAND = 410, (10, 2)
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
ENC_TOL = 1e-3
GAP_TOL = 1e-3
LATTICE_TOL = dict(rtol=1e-5, atol=1e-3)
GRAD_TOL = 1e-4          # atol GRAD_TOL * max|ref| + GRAD_FLOOR, rtol GRAD_TOL
GRAD_FLOOR = 1e-5        # for gradients that are 0 in exact arithmetic (T = 1)
B_TRAIN = 4              # configs/joint_streaming.yaml data.batch_size
LOSS_RTOL, NORM_RTOL = 1e-4, 1e-3


def log(*args):
    print(*args, flush=True)


def require(ok: bool, what) -> None:
    """A check of the run that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, samples: int = 20, reps: int = 10) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls, timed with CUDA events after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_ms(fns: dict, samples: int = 10) -> dict:
    """Wall times (ms) of calls that end in a synchronise, after a warm-up:
    ``samples`` rounds in which every function runs once, in an order that
    reverses each round, so drift on a shared host falls on all alike."""
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for r in range(samples):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            start = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - start) * 1e3)
    return times


def spread(ms: list) -> str:
    """Median and quartiles of host-clock samples."""
    q1, _, q3 = statistics.quantiles(ms, n=4)
    return f"{statistics.median(ms):.2f} ms [quartiles {q1:.2f}, {q3:.2f}]"


def split_ms(encode, decode, samples: int = 10):
    """Median host ms of the encoder and of the greedy loop, each phase of
    the same call timed between synchronises."""
    import torch
    enc_ms, dec_ms = [], []
    for r in range(samples + 1):
        torch.cuda.synchronize()
        start = time.perf_counter()
        with torch.no_grad():
            enc = encode()
        torch.cuda.synchronize()
        mid = time.perf_counter()
        decode(enc)
        torch.cuda.synchronize()
        if r:                                   # round 0 warms up
            enc_ms.append((mid - start) * 1e3)
            dec_ms.append((time.perf_counter() - mid) * 1e3)
    return statistics.median(enc_ms), statistics.median(dec_ms)


def attention_inputs(tlen, k_len, gen, b=B):
    """q, k, v as strided views of one fused projection (as the model hands
    them over), and tables of ``k_len`` rows sliced/front-padded to T."""
    import torch
    from transformer_transducer_tpu_torch.models.attention import slice_pos_table
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    q, k, v = mk(b, tlen, 3, H, DH).unbind(2)
    re = slice_pos_table(mk(k_len, H, DH), tlen)
    rb = slice_pos_table(mk(k_len, H), tlen)
    return q, k, v, re, mk(H, DH), rb


def band_cells(tlen, left, right):
    """(i, j) cells inside the band and the sequence, per (b, h)."""
    return sum(min(tlen - 1, i + right) - max(0, i - left) + 1
               for i in range(tlen))


def device_busy_ms(fn):
    """Summed duration of the device activities (kernels, copies) of one
    call, from ``torch.profiler``; 0.0 when the profiler sees no device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def roofline(n_bytes, n_ops):
    """(least ms, "bytes" or "operations") at the card's published peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bound(tlen, cells):
    """Least time for the work: each input read once, the output written
    once; 2*Dh FLOP each for AC, BD and AV per live cell."""
    elems = 4 * B * tlen * H * DH + tlen * H * DH + H * DH + tlen * H
    return roofline(4 * elems, B * H * cells * 6 * DH)


def backward_bound(b, tlen, cells):
    """Least time for the attention backward: q, k, v, dO and the tables
    read once, dq, dk, dv and the table gradients written once; about 16*Dh
    FLOP per live cell (scores again, dp, dv, dk, dq from AC and BD, and the
    table gradient)."""
    elems = 7 * b * tlen * H * DH + 2 * (tlen * H * DH + H * DH + tlen * H)
    return roofline(4 * elems, b * H * cells * 16 * DH)


def lattice_bound(b, d_total, u1, n_grids):
    """Least time for a lattice sweep: ``n_grids`` (B, D, U1) fp32 arrays
    read or written once; about 10 operations per cell (two adds and the
    log-add-exp), far below the bytes."""
    return roofline(4 * n_grids * b * d_total * u1, 10 * b * d_total * u1)


def lattice_inputs(b, tlen, u, gen, with_empty=True):
    """Skewed blank/label grids and the terminal inject as the loss builds
    them (``ops/rnnt_loss.lattice_grids``, ``terminal_inject``): log-probs of
    random logits over 64 classes; row 0 at full length, row 1 with no
    frames (when ``with_empty``), the rest of random lengths."""
    import torch
    from transformer_transducer_tpu_torch.ops import rnnt_loss
    logp = torch.log_softmax(torch.randn(b, tlen, u + 1, 64, generator=gen,
                                         device="cuda") * 2, dim=-1)
    lp_b, lp_l = logp[..., 0], logp[..., 1]
    t_len = torch.randint(1, tlen + 1, (b,), generator=gen, device="cuda")
    u_len = torch.randint(0, u + 1, (b,), generator=gen, device="cuda")
    t_len[0], u_len[0] = tlen, u
    if with_empty and b > 1:
        t_len[1] = 0
    sb, sl, t_len, u_len = rnnt_loss.lattice_grids(lp_b, lp_l, t_len, u_len)
    return sb, sl, rnnt_loss.terminal_inject(sb, t_len, u_len)[1]


def attention_grads(fn, leaves, gout):
    """The output and the six gradients (q, k, v, un-sliced r_emb, r_w_bias,
    r_bias) of ``fn`` on the leaves ``(qkv, r_emb, r_w_bias, r_bias)``."""
    from transformer_transducer_tpu_torch.models.attention import slice_pos_table
    for x in leaves:
        x.grad = None
    qkv, re, u, rb = leaves
    q, k, v = qkv.unbind(2)
    tlen = q.shape[1]
    out = fn(q, k, v, slice_pos_table(re, tlen), u, slice_pos_table(rb, tlen))
    out.backward(gout)
    return [out.detach(), *qkv.grad.unbind(2), re.grad, u.grad, rb.grad]


def check_training_kernels(gen):
    """Phase 3, the training kernels: the lattice sweeps against the eager
    scans and the attention backward against autograd through the plain
    versions; returns the largest abs error of each kernel."""
    import torch
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention, banded_attention_plain)
    from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
        flash_rel_attention, flash_rel_attention_plain)
    from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import (
        alpha_scan, alpha_scan_plain, beta_scan, beta_scan_plain)
    errs = {"alpha": 0.0, "beta": 0.0, "banded_bwd": 0.0, "flash_bwd": 0.0}
    log(f"lattice sweeps vs eager scans (rtol {LATTICE_TOL['rtol']}, atol "
        f"{LATTICE_TOL['atol']}):")
    shapes = [(B_TRAIN, T_MAIN, 42)] + [(B_TRAIN, t, u) for t in (1, 37, 410)
                                        for u in (0, 1, 42)]
    for b, tlen, u in shapes:
        sb, sl, inject = lattice_inputs(b, tlen, u, gen)
        pairs = (("alpha", alpha_scan(sb, sl), alpha_scan_plain(sb, sl)),
                 ("beta", beta_scan(sb, sl, inject),
                  beta_scan_plain(sb, sl, inject)))
        torch.cuda.synchronize()
        line = []
        for name, got, ref in pairs:
            err = (got - ref).abs().max().item()
            torch.testing.assert_close(got, ref, **LATTICE_TOL)
            errs[name] = max(errs[name], err)
            line.append(f"{name} {err:.3e}")
        log(f"  B={b} T={tlen:3d} U={u:2d}: max|err| " + ", ".join(line))

    log(f"attention backward vs autograd through the plain versions (atol "
        f"{GRAD_TOL} * max|ref| + {GRAD_FLOOR}, rtol {GRAD_TOL}):")
    names = ("out", "dq", "dk", "dv", "d_r_emb", "d_r_w_bias", "d_r_bias")
    for tlen in (1, 37, 410, 513):
        for band in (None, (10, 2), (0, 0), (64, 64)):
            mk = lambda *s: (torch.randn(*s, generator=gen, device="cuda")
                             * 0.5).requires_grad_()
            leaves = [mk(B_TRAIN, tlen, 3, H, DH), mk(T_MAIN, H, DH), mk(H, DH),
                      mk(T_MAIN, H)]
            gout = torch.randn(B_TRAIN, tlen, H, DH, generator=gen, device="cuda")
            if band is None:
                key, kern, plain = "flash_bwd", flash_rel_attention, \
                    flash_rel_attention_plain
            else:
                key = "banded_bwd"
                kern = lambda *a, band=band: banded_attention(*a, *band)
                plain = lambda *a, band=band: banded_attention_plain(*a, *band)
            got = attention_grads(kern, leaves, gout)
            ref = attention_grads(plain, leaves, gout)
            torch.cuda.synchronize()
            line = []
            for name, a, r in zip(names, got, ref):
                err = (a - r).abs().max().item()
                torch.testing.assert_close(
                    a, r, atol=GRAD_TOL * r.abs().max().item() + GRAD_FLOOR,
                    rtol=GRAD_TOL, msg=f"T={tlen} band={band} {name}")
                if name != "out":
                    errs[key] = max(errs[key], err)
                line.append(f"{name} {err:.2e}")
            label = "flash " if band is None else f"banded ({band[0]},{band[1]})"
            log(f"  {label} T={tlen:3d}: " + ", ".join(line))
    return errs


@contextlib.contextmanager
def plain_versions():
    """Route the attention and lattice wrappers to their plain versions on
    the card (the comparisons' reference path)."""
    from transformer_transducer_tpu_torch.ops import rnnt_loss
    from transformer_transducer_tpu_torch.ops.cuda import banded_attention as ba
    from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
    from transformer_transducer_tpu_torch.ops.cuda import rnnt_kernel as rk
    saved = (ba.banded_attention, fa.flash_rel_attention, rnnt_loss.alpha_scan,
             rnnt_loss.beta_scan)
    ba.banded_attention = ba.banded_attention_plain
    fa.flash_rel_attention = fa.flash_rel_attention_plain
    rnnt_loss.alpha_scan, rnnt_loss.beta_scan = rk.alpha_scan_plain, rk.beta_scan_plain
    try:
        yield
    finally:
        (ba.banded_attention, fa.flash_rel_attention, rnnt_loss.alpha_scan,
         rnnt_loss.beta_scan) = saved


@functools.lru_cache(maxsize=None)
def counters():
    """The launch counters of every kernel wrapper, by name (the wrappers
    themselves, read before ``plain_versions`` can swap them out)."""
    from transformer_transducer_tpu_torch.ops.cuda import banded_attention as ba
    from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
    from transformer_transducer_tpu_torch.ops.cuda import rnnt_kernel as rk
    return {"banded_fwd": ba.banded_attention, "banded_bwd": ba.banded_attention_backward,
            "flash_fwd": fa.flash_rel_attention,
            "flash_bwd": fa.flash_rel_attention_backward,
            "alpha": rk.alpha_scan, "beta": rk.beta_scan}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def training_batch(cfg, device, seed):
    """B_TRAIN synthetic utterances of 60-410 frames through the dataset's
    host frontend (log-mel eps, stack, subsample), padded to
    max_input_length, with 5-42 random targets; and its seconds of audio."""
    import numpy as np
    from transformer_transducer_tpu_torch.ops import features_np as F
    from transformer_transducer_tpu_torch.training.train_step import batch_to_device
    from transformer_transducer_tpu_torch.utils.config import (
        stack_context, subsample_factor)
    waves = synthetic_waves(B_TRAIN, seed)
    left, right = stack_context(cfg.data)
    feats = [F.subsample(F.stack_frames(F.logmel_eps(w, 16000, cfg.data.feature_dim),
                                        left, right), subsample_factor(cfg.data))
             for w in waves]
    t_max, u_max = cfg.data.max_input_length, cfg.data.max_target_length
    x = np.zeros((B_TRAIN, t_max, feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        x[i, :min(len(f), t_max)] = f[:t_max]
    rng = np.random.default_rng(seed)
    u_len = np.linspace(5, u_max, B_TRAIN).astype(np.int64)
    targets = np.zeros((B_TRAIN, u_max), np.int64)
    for i, n in enumerate(u_len):
        targets[i, :n] = rng.integers(1, cfg.model.vocab_size, n)
    batch = {"inputs": x, "inputs_length": np.array([min(len(f), t_max) for f in feats]),
             "targets": targets, "targets_length": u_len}
    return batch_to_device(batch, device), sum(len(w) for w in waves) / 16000.0


def make_trainee(model_cfg, optim_cfg, state, mode, device):
    """A model in train mode with ``state``, its SGD optimizer (momentum,
    clip 200 as the trainer builds it) and its train step (SpecAugment on)."""
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.training.optim import build_optimizer
    from transformer_transducer_tpu_torch.training.train_step import (
        TrainStepConfig, make_train_step)
    model = build_transducer(model_cfg, flash=mode == "flash",
                             banded=mode == "banded", device=device)
    model.load_state_dict(state)
    model.train()
    opt = build_optimizer(optim_cfg, list(model.parameters()), max_grad_norm=200.0)
    return model, opt, make_train_step(model, opt, TrainStepConfig())


def train_three_steps(model_cfg, optim_cfg, state, mode, batch, device, plain):
    """Phase 6: 3 steps from ``state`` with the SpecAugment stream seeded
    alike; per step (loss, raw gradient norm, launch counts)."""
    import torch
    model, opt, step = make_trainee(model_cfg, optim_cfg, state, mode, device)
    gen = torch.Generator().manual_seed(0)
    out = []
    with plain_versions() if plain else contextlib.nullcontext():
        for _ in range(3):
            reset_counts()          # the main path: counts from 0, read after
            m = step(batch, gen)
            torch.cuda.synchronize()
            out.append((float(m["loss"]), float(m["grad_norm"]), read_counts()))
    return out


def check_kernels(gen):
    """Phase 3: every kernel against its plain version; returns the largest
    abs error of each."""
    import torch
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention, banded_attention_plain)
    from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
        flash_rel_attention, flash_rel_attention_plain)
    errs = {"banded": 0.0, "flash": 0.0}
    for tlen in (1, 37, 129, 410):
        for left, right in ((10, 2), (0, 0), (64, 64)):
            args = attention_inputs(tlen, 410, gen)
            got = banded_attention(*args, left, right)
            ref = banded_attention_plain(*args, left, right)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            log(f"  banded T={tlen:4d} band=({left},{right}): max|err| {err:.3e}")
            torch.testing.assert_close(got, ref, **KERNEL_TOL)
            errs["banded"] = max(errs["banded"], err)
    for tlen in (1, 37, 410, 513):
        args = attention_inputs(tlen, 410, gen)     # 513 > k_len: front pad
        got = flash_rel_attention(*args)
        ref = flash_rel_attention_plain(*args)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        log(f"  flash  T={tlen:4d}: max|err| {err:.3e}")
        torch.testing.assert_close(got, ref, **KERNEL_TOL)
        errs["flash"] = max(errs["flash"], err)
    return errs


def synthetic_waves(n_utts, seed):
    """int16 waves of 60..410 frames after the frontend (about 1.8-12.3 s):
    voiced chirps with pauses and noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    waves = []
    for frames in np.linspace(60, T_MAIN, n_utts).astype(int):
        n = 480 * (frames - 1)            # hop 160, subsample 3
        tt = np.arange(n) / 16000.0
        f0 = rng.uniform(100, 300)
        sig = sum(np.sin(2 * np.pi * f0 * m * tt * (1 + 0.1 * np.sin(3 * tt))) / m
                  for m in (1, 2, 3))
        sig *= 0.2 + (np.sin(2 * np.pi * rng.uniform(1, 3) * tt) > -0.3)
        waves.append(((sig + 0.05 * rng.standard_normal(n)) * 4000).astype(np.int16))
    return waves


def greedy_trace(model, enc1, t_len, max_tokens):
    """One utterance's greedy decode, frame by frame: (token or 0, top-2
    logit gap) per frame."""
    import torch
    from transformer_transducer_tpu_torch.decoding import label_cache as lc
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    cache = lc.init_cache(model.decoder, 1, max_tokens)
    dec, cache = lc.step(model.decoder, torch.zeros(1, dtype=torch.long,
                                                    device="cuda"), cache, one)
    count, out = 1, []
    for t in range(t_len):
        logits = model.joint_logits(enc1[:, t], dec)[0]
        top = logits.topk(2).values
        pred = int(logits.argmax())
        emit = pred != 0 and count < max_tokens
        out.append((pred if emit else 0, float(top[0] - top[1])))
        if emit:
            dec, cache = lc.step(model.decoder, torch.tensor([pred], device="cuda"),
                                 cache, one)
            count += 1
    return out


def compare_tokens(name, got, ref, model, enc_k, enc_p, t_len, max_tokens):
    """Tokens must be identical; where they are not, the first differing
    frame must be a tie (top-2 gap <= GAP_TOL), else the run fails."""
    if got == ref:
        log(f"  {name}: tokens identical ({sum(map(len, got))} tokens)")
        return
    for u, (a, b) in enumerate(zip(got, ref)):
        if a == b:
            continue
        ta = greedy_trace(model, enc_k[u:u + 1], int(t_len[u]), max_tokens)
        tb = greedy_trace(model, enc_p[u:u + 1], int(t_len[u]), max_tokens)
        frame = next(i for i, (x, y) in enumerate(zip(ta, tb)) if x[0] != y[0])
        gap = max(ta[frame][1], tb[frame][1])
        log(f"  {name}: utterance {u} first differs at frame {frame}, "
            f"top-2 logit gap {gap:.3e}")
        if gap > GAP_TOL:
            raise AssertionError(f"{name}: kernel and plain tokens diverge at "
                                 f"utterance {u}, frame {frame} (gap {gap:.3e})")


def load_flagship():
    """``configs/joint_streaming.yaml`` as a port ``Config``."""
    from transformer_transducer_tpu_torch.utils.config import Config, parse_yaml
    with open(os.path.join(HERE, "configs", "joint_streaming.yaml"),
              encoding="utf-8") as fh:
        return Config(parse_yaml(fh.read()))


def write_corpus(root, cfg) -> str:
    """16 train and 8 dev synthetic waves with random labels over a vocabulary
    of ``vocab_size`` symbols, and the flagship config pointing at them;
    returns the config's path."""
    import numpy as np
    from transformer_transducer_tpu_torch.data.wav import write_wave
    from transformer_transducer_tpu_torch.utils.config import dump_config
    from transformer_transducer_tpu_torch.utils.vocab import Vocabulary
    chars = [chr(0x4E00 + i) for i in range(cfg.model.vocab_size - 2)]
    vocab_path = os.path.join(root, "vocab.txt")
    Vocabulary.from_symbols(chars + ["<unk>"]).save(vocab_path)
    rng = np.random.default_rng(3)
    cli_cfg = load_flagship()
    cli_cfg.override("data.vocab", vocab_path)
    for split, n, seed in (("train", 16, 2), ("dev", 8, 3)):
        lines = ["file_path,label"]
        for i, wave in enumerate(synthetic_waves(n, seed)):
            path = os.path.join(root, f"{split}_{i}.wav")
            write_wave(path, wave)
            n_tok = int(rng.integers(5, cfg.data.max_target_length + 1))
            lines.append(path + "," + "".join(rng.choice(chars, n_tok)))
        csv_path = os.path.join(root, f"{split}.csv")
        with open(csv_path, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + "\n")
        cli_cfg.override(f"data.{split}", csv_path)
    cli_cfg.override("data.test", cli_cfg.data.dev)
    cfg_path = os.path.join(root, "config.yaml")
    dump_config(cli_cfg, cfg_path)
    return cfg_path


def split_step(model, opt, batch, gen, samples: int = 5) -> dict:
    """Median host ms of a train step's phases, each ended by a synchronise:
    encoder forward (SpecAugment + ``encode_both``), loss forward (the fused
    joint and the lattice), backward, optimizer (gradient norm + update)."""
    import torch
    from transformer_transducer_tpu_torch.ops.rnnt_loss import (
        joint_params, rnnt_loss_fused)
    from transformer_transducer_tpu_torch.ops.specaug import spec_augment
    from transformer_transducer_tpu_torch.training.optim import global_norm
    from transformer_transducer_tpu_torch.training.train_step import TrainStepConfig
    cfg = TrainStepConfig()
    names = ("encoder forward", "loss forward", "backward", "optimizer")
    times = {n: [] for n in names}
    for r in range(samples + 1):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        model.train()
        for p in opt.params:
            p.grad = None
        x = spec_augment(gen, batch["inputs"], cfg.max_mask_time,
                         cfg.max_mask_frequency, cfg.mask_num)
        enc, dec = model.encode_both(x, batch["targets"])
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        loss = rnnt_loss_fused(enc, dec, joint_params(model), batch["targets"],
                               batch["inputs_length"], batch["targets_length"],
                               chunk_size=cfg.loss_chunk_size, remat=cfg.loss_remat)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in opt.params]
        global_norm(grads)
        opt.step(grads)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if r:                                   # round 0 warms up
            for name, a, b in zip(names, marks, marks[1:]):
                times[name].append((b - a) * 1e3)
    return {n: statistics.median(v) for n, v in times.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: {PKG}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    from transformer_transducer_tpu_torch.decoding.greedy import (
        greedy_decode, recognize)
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.ops import features_np as F
    from transformer_transducer_tpu_torch.ops.cuda import build
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention, banded_attention_plain)
    from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
        flash_rel_attention, flash_rel_attention_plain)
    from transformer_transducer_tpu_torch.ops.masks import context_mask
    from transformer_transducer_tpu_torch.utils.config import (
        Config, stack_context, subsample_factor)
    from transformer_transducer_tpu_torch.utils.convert import (
        from_jax_params, random_jax_params)
    from transformer_transducer_tpu_torch.utils.device import resolve_device

    # ---- 1. device
    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"device: {kind}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}); nvcc: {nvcc}")

    # ---- 2. build
    start = time.perf_counter()
    lib_path = build.build()
    build.library()
    log(f"kernels built in {time.perf_counter() - start:.1f} s -> "
        f"{os.path.relpath(lib_path, HERE)}")
    ptxas = lib_path.with_name(lib_path.stem + ".ptxas.txt")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())

    # ---- 3. kernels vs plain versions
    log("kernels vs plain versions (atol 1e-4, rtol 1e-4):")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_kernels(gen)
    errs.update(check_training_kernels(gen))

    # ---- 4. the slice at full width
    cfg = load_flagship()
    left_ctx, right_ctx = stack_context(cfg.data)
    n_mels = cfg.data.feature_dim
    max_tokens = cfg.data.max_target_length + 1
    band = (cfg.model.enc.left_context, cfg.model.enc.right_context)
    state = from_jax_params(random_jax_params(cfg.model, seed=0))
    models = {}
    for flash in (False, True):
        models[flash] = build_transducer(cfg.model, flash=flash, device=device)
        models[flash].load_state_dict(state)
    model, model_flash = models[False], models[True]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"flagship model: {cfg.model.enc.n_layer} encoder layers, d_model "
        f"{cfg.model.enc.d_model}, V {cfg.model.vocab_size}, {n_params} parameters")

    waves = synthetic_waves(8, seed=0)
    start = time.perf_counter()
    feats = [F.subsample(F.stack_frames(F.logmel_masked(w, 16000, n_mels),
                                        left_ctx, right_ctx),
                         subsample_factor(cfg.data)) for w in waves]
    frontend_ms = (time.perf_counter() - start) * 1e3
    t_len = np.array([f.shape[0] for f in feats])
    x_np = np.zeros((len(feats), t_len.max(), feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        x_np[i, :len(f)] = f
    x = torch.from_numpy(x_np).to(device)
    audio_s = sum(len(w) for w in waves) / 16000.0
    log(f"batch: {len(waves)} utterances, {audio_s:.2f} s of audio, frames "
        f"{t_len.tolist()}, host frontend {frontend_ms:.1f} ms")
    require(t_len.max() == T_MAIN and x.shape[-1] == cfg.model.enc.d_model,
            "the batch is not at the flagship width")

    # bias the blank logit so that about 15 % of frames emit at the seed
    # label state (untrained weights emit on nearly every frame)
    with torch.no_grad():
        enc = model.encode(x, context_mask(T_MAIN, *band, device=device))
        dec = model.predict(torch.zeros((len(waves), 1), dtype=torch.long,
                                        device=device))
        logits = model.joint_logits(enc, dec)[:, :, 0]
        margin = logits[..., 1:].max(-1).values - logits[..., 0]
        valid = torch.arange(T_MAIN, device=device)[None] < torch.from_numpy(
            t_len).to(device)[:, None]
        offset = torch.quantile(margin[valid], 0.85).item()
        for m in models.values():
            m.joint.project_layer.bias[0] += offset
    log(f"blank logit biased by {offset:.3f}")

    # the main path: counts set to 0 just before, read just after
    reset_counts()
    tok_band = recognize(model, x, t_len, band=band, max_tokens=max_tokens)
    tok_full = recognize(model_flash, x, t_len, max_tokens=max_tokens)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {"banded": counts["banded_fwd"], "flash": counts["flash_fwd"]}
    log(f"main path launches: banded {launches['banded']}, flash "
        f"{launches['flash']} (18 per encode expected)")
    n_layer = cfg.model.enc.n_layer
    require(counts == {"banded_fwd": n_layer, "flash_fwd": n_layer, "banded_bwd": 0,
                       "flash_bwd": 0, "alpha": 0, "beta": 0},
            f"the main path did not launch each kernel once a layer: {counts}")

    n_frames = int(t_len.sum())
    for name, toks in (("band", tok_band), ("full-context", tok_full)):
        require(len(toks) == len(waves)
                and all(len(r) < max_tokens and 0 not in r for r in toks),
                f"{name}: malformed token lists")
        log(f"  {name}: {sum(map(len, toks))} tokens over {n_frames} frames "
            f"({100.0 * sum(map(len, toks)) / n_frames:.1f} % emission)")

    # the same through the plain versions: the dense masked path (band) and
    # a flash=False model (full context)
    with torch.no_grad():
        mask = context_mask(T_MAIN, *band, device=device)
        enc_band_k = model.encode_banded(x, *band)
        enc_band_p = model.encode(x, mask)
        enc_full_k = model_flash.encode(x)
        enc_full_p = model.encode(x)
    tok_band_p = recognize(model, x, t_len, audio_mask=mask, max_tokens=max_tokens)
    tok_full_p = recognize(model, x, t_len, max_tokens=max_tokens)
    for name, a, b in (("band", enc_band_k, enc_band_p),
                       ("full-context", enc_full_k, enc_full_p)):
        require(a.shape == (len(waves), T_MAIN, cfg.model.enc.d_model)
                and bool(torch.isfinite(a).all()),
                f"{name}: encoder states of a wrong shape or not finite")
        err = (a - b).abs().max().item()
        log(f"  {name}: encoder states kernel vs plain max|err| {err:.3e} "
            f"(tolerance {ENC_TOL})")
        require(err <= ENC_TOL, f"{name}: encoder states differ by {err}")
    compare_tokens("band", tok_band, tok_band_p, model, enc_band_k, enc_band_p,
                   t_len, max_tokens)
    compare_tokens("full-context", tok_full, tok_full_p, model, enc_full_k,
                   enc_full_p, t_len, max_tokens)

    # ---- 5. timings at the flagship shape (B=8, T=410, H=8, Dh=64)
    log(f"timings on {smi}:")
    args = attention_inputs(T_MAIN, 410, gen)
    q, k, v, re, u, rb = args
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (z.transpose(1, 2) for z in (q, k, v))
    with torch.no_grad():
        # yardstick only: SDPA with the BD term precomputed as an additive
        # mask (leaves out building BD); the port never calls it
        from transformer_transducer_tpu_torch.models.attention import rel_shift
        bd = rel_shift(torch.einsum("bind,jnd->bnij", q, re) + rb.t()[None, :, None, :])
        u_k = torch.einsum("nd,bjnd->bnj", u, k)[:, :, None, :]   # (q+u).k - q.k
        add = (bd + u_k) / DH ** 0.5
        add_band = add.masked_fill(context_mask(T_MAIN, *band, device=device),
                                   float("-inf"))
        yard_err = (sdpa(qh, kh, vh, attn_mask=add).transpose(1, 2)
                    - flash_rel_attention_plain(*args)).abs().max().item()
    log(f"  SDPA yardstick vs plain full attention: max|err| {yard_err:.3e}")
    records = []
    rows = (
        ("banded_attention_fwd", "banded",
         "transformer_transducer_tpu/ops/pallas/banded_attention.py:151",
         lambda: banded_attention(*args, *band),
         lambda: banded_attention_plain(*args, *band),
         lambda: sdpa(qh, kh, vh, attn_mask=add_band),
         band_cells(T_MAIN, *band)),
        ("flash_rel_attention_fwd", "flash",
         "transformer_transducer_tpu/ops/pallas/flash_rel_attention.py:248",
         lambda: flash_rel_attention(*args),
         lambda: flash_rel_attention_plain(*args),
         lambda: sdpa(qh, kh, vh, attn_mask=add),
         T_MAIN * T_MAIN),
    )
    for name, key, replaces, kern, plain, yard, cells in rows:
        ms, plain_ms, yard_ms = cuda_ms(kern), cuda_ms(plain), cuda_ms(yard)
        bound_ms, bound_by = bound(T_MAIN, cells)
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f} % of "
            f"bound; SDPA with BD as a precomputed mask (yardstick) {yard_ms:.4f} ms")
        records.append({
            "name": name, "route": "cuda",
            "source": f"{PKG}/csrc/rel_attention.cu", "replaces": replaces,
            "launches": launches[key], "max_abs_err": errs[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "sdpa_bd_mask_yardstick_ms": yard_ms})

    runs = {
        "band, kernel": lambda: recognize(model, x, t_len, band=band,
                                          max_tokens=max_tokens),
        "band, plain": lambda: recognize(model, x, t_len, audio_mask=mask,
                                         max_tokens=max_tokens),
        "full-context, kernel": lambda: recognize(model_flash, x, t_len,
                                                  max_tokens=max_tokens),
        "full-context, plain": lambda: recognize(model, x, t_len,
                                                 max_tokens=max_tokens)}
    e2e = host_ms(runs)
    for name, ms in e2e.items():
        med = statistics.median(ms)
        log(f"  recognize B=8 ({name}): {spread(ms)}, real-time factor "
            f"{med / 1e3 / audio_s:.5f} ({audio_s * 1e3 / med:.0f}x real time)")
    # where the kernels' recognize spends its time: the encoder, then the
    # frame-by-frame greedy loop; and the device's busy share of the whole
    decode = lambda enc: greedy_decode(model, enc, t_len, max_tokens)
    for name, encode in (("band", lambda: model.encode_banded(x, *band)),
                         ("full-context", lambda: model_flash.encode(x))):
        with torch.no_grad():
            enc_dev = cuda_ms(encode, samples=10, reps=3)
        enc_ms, dec_ms = split_ms(encode, decode)
        busy = device_busy_ms(runs[f"{name}, kernel"])
        e2e_ms = statistics.median(e2e[f"{name}, kernel"])
        share = (f"{100 * (1 - busy / e2e_ms):.1f} %" if busy > 0
                 else "not measured (the profiler saw no device time)")
        log(f"  {name}, kernel: encode {enc_dev:.3f} ms on the device; in one "
            f"call, encode {enc_ms:.2f} ms + greedy loop {dec_ms:.2f} ms (host "
            f"clock); device busy {busy:.2f} ms of one recognize, idle share "
            f"{share} of the median recognize")
    # ---- 6. training at full width: kernels, then the plain versions
    del models, model, model_flash, enc, dec, logits, enc_band_k, enc_band_p, \
        enc_full_k, enc_full_p
    torch.cuda.empty_cache()
    model_cfg0 = load_flagship().model
    model_cfg0.override("dropout", 0.0)           # --set model.dropout=0
    optim_cfg = Config({"type": "sgd", "lr": cfg.optim.lr, "momentum": 0.9})
    batch, batch_audio_s = training_batch(cfg, device, seed=1)
    log(f"training batch: {B_TRAIN} utterances, {batch_audio_s:.2f} s of audio, "
        f"frames {batch['inputs_length'].tolist()}, targets "
        f"{batch['targets_length'].tolist()}; SGD lr {cfg.optim.lr}, momentum "
        f"0.9, clip 200; dropout 0 for the comparison")
    per_step = {"flash": {"flash_fwd": n_layer, "flash_bwd": n_layer},
                "banded": {"banded_fwd": n_layer, "banded_bwd": n_layer}}
    train_launches = dict.fromkeys(read_counts(), 0)
    for mode in ("flash", "banded"):
        kern = train_three_steps(model_cfg0, optim_cfg, state, mode, batch,
                                 device, plain=False)
        plain = train_three_steps(model_cfg0, optim_cfg, state, mode, batch,
                                  device, plain=True)
        want = dict.fromkeys(train_launches, 0)
        want.update(per_step[mode], alpha=1, beta=1)
        for i, ((lk, nk, ck), (lp, norm_p, cp)) in enumerate(zip(kern, plain)):
            rel = abs(lk - lp) / abs(lp)
            log(f"  {mode} step {i + 1}: loss kernel {lk:.6f} / plain {lp:.6f} "
                f"(rel {rel:.2e}), grad norm {nk:.5f} / {norm_p:.5f}; "
                f"launches {ck}")
            require(ck == want, f"{mode} step {i + 1}: launches {ck}, want {want}")
            require(not any(cp.values()), f"{mode} plain step launched {cp}")
            require(rel <= LOSS_RTOL, f"{mode} step {i + 1}: losses differ by {rel:.2e}")
            for name, n in ck.items():
                train_launches[name] += n
        rel = abs(kern[0][1] - plain[0][1]) / abs(plain[0][1])
        log(f"  {mode}: step 1 grad norm rel diff {rel:.2e} (tolerance {NORM_RTOL})")
        require(rel <= NORM_RTOL, f"{mode}: step 1 grad norms differ by {rel:.2e}")

    # ---- 7. the training entry point: one epoch, then -mode continue
    from transformer_transducer_tpu_torch.apps import train as train_app
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = write_corpus(tmp, cfg)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            reset_counts()
            start = time.perf_counter()
            first = train_app.main(["-config", cfg_path, "--flash", "--epochs", "1"])
            second = train_app.main(["-config", cfg_path, "--flash", "-mode",
                                     "continue", "--epochs", "2"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - start
            cli_counts = read_counts()
        finally:
            os.chdir(cwd)
        exp = os.path.join(tmp, first.exp_dir)
        with open(os.path.join(exp, "metrics.jsonl"), encoding="utf-8") as fh:
            cers = [r["value"] for r in map(json.loads, fh) if r["tag"] == "cer"]
        log(f"apps/train.py --flash: 2 epochs (the second by -mode continue) in "
            f"{cli_s:.1f} s, {second.global_step} steps, CER per epoch {cers}, "
            f"launches {cli_counts}")
        require(second.start_epoch == 1 and second.global_step == 2 * 4,
                f"continue mode resumed at epoch {second.start_epoch}, step "
                f"{second.global_step}")
        for epoch in (0, 1):
            require(os.path.exists(os.path.join(exp, f"epoch_{epoch}", "model.pt")),
                    f"no epoch_{epoch} checkpoint")
            require(os.path.getsize(os.path.join(exp, f"decode_{epoch}.txt")) > 0,
                    f"no decode dump for epoch {epoch}")
        require(len(cers) == 2 and all(np.isfinite(cers)), f"CER {cers}")
        require(all(cli_counts[k] > 0 for k in ("flash_fwd", "flash_bwd", "alpha", "beta"))
                and cli_counts["banded_fwd"] == cli_counts["banded_bwd"] == 0,
                f"the entry point did not run the flash and lattice kernels: {cli_counts}")
        del first, second
    torch.cuda.empty_cache()

    # ---- 8. training timings (B=4, T=410, H=8, Dh=64)
    from transformer_transducer_tpu_torch.ops.cuda import common
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention_backward)
    from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
        flash_rel_attention_backward)
    from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import (
        alpha_scan, alpha_scan_plain, beta_scan, beta_scan_plain)
    log(f"training timings on {smi}:")
    for rec in records:          # the forward kernels ran in training too
        rec["launches"] += train_launches[f"{rec['name'].split('_')[0]}_fwd"]
    sb, sl, inject = lattice_inputs(B_TRAIN, T_MAIN, 42, gen, with_empty=False)
    d_total, u1 = sb.shape[1], sb.shape[2]
    for name, key, replaces, kern, plain, n_grids in (
            ("rnnt_alpha", "alpha", "rnnt_kernel.py:158",
             lambda: alpha_scan(sb, sl), lambda: alpha_scan_plain(sb, sl), 3),
            ("rnnt_beta", "beta", "rnnt_kernel.py:190",
             lambda: beta_scan(sb, sl, inject),
             lambda: beta_scan_plain(sb, sl, inject), 4)):
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain, samples=5, reps=2)
        bound_ms, bound_by = lattice_bound(B_TRAIN, d_total, u1, n_grids)
        log(f"  {name} (B={B_TRAIN}, D={d_total}, U1={u1}): kernel {ms:.4f} ms "
            f"({1e3 * ms / (d_total - 1):.3f} us per dependent diagonal), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
            f"{train_launches[key] // 6} launch per step")
        records.append({
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/rnnt_lattice.cu",
            "replaces": f"transformer_transducer_tpu/ops/pallas/{replaces}",
            "launches": train_launches[key], "max_abs_err": errs[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})

    args = attention_inputs(T_MAIN, 410, gen, b=B_TRAIN)
    gout = torch.randn(B_TRAIN, T_MAIN, H, DH, generator=gen, device="cuda")
    leaves = [a.detach().requires_grad_() for a in args]
    q, k, v, re, u, rb = args
    qh, kh, vh = (z.transpose(1, 2).detach().requires_grad_() for z in (q, k, v))
    with torch.no_grad():
        from transformer_transducer_tpu_torch.models.attention import rel_shift
        bd = rel_shift(torch.einsum("bind,jnd->bnij", q, re) + rb.t()[None, :, None, :])
        add = (bd + torch.einsum("nd,bjnd->bnj", u, k)[:, :, None, :]) / DH ** 0.5
        add_band = add.masked_fill(context_mask(T_MAIN, *band, device=device),
                                   float("-inf"))
    for name, key, fn, bwd, plain_fn, extra, mask_add, cells, replaces in (
            ("banded_attention_bwd", "banded", "ttx_banded_attention_fwd",
             banded_attention_backward, banded_attention_plain, band, add_band,
             band_cells(T_MAIN, *band), "banded_attention.py:346"),
            ("flash_rel_attention_bwd", "flash", "ttx_flash_rel_attention_fwd",
             flash_rel_attention_backward, flash_rel_attention_plain, (), add,
             T_MAIN * T_MAIN, "flash_rel_attention.py:288")):
        out, lse, _ = common.launch_forward(fn, args, tuple(extra), with_lse=True)
        out_p = plain_fn(*leaves, *extra)
        # yardstick only: SDPA's backward on q, k, v with BD as a
        # precomputed additive mask (no table gradients); never in the port
        out_s = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask_add)
        ms = cuda_ms(lambda: bwd(*args, out, lse, gout, *extra))
        plain_ms = cuda_ms(lambda: torch.autograd.grad(out_p, leaves, gout,
                                                       retain_graph=True))
        yard_ms = cuda_ms(lambda: torch.autograd.grad(
            out_s, (qh, kh, vh), gout.transpose(1, 2), retain_graph=True))
        bound_ms, bound_by = backward_bound(B_TRAIN, T_MAIN, cells)
        log(f"  {name}: kernel {ms:.4f} ms, plain (autograd) {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f} % "
            f"of bound; SDPA backward with BD as a precomputed mask (yardstick) "
            f"{yard_ms:.4f} ms; {n_layer} launches per step")
        records.append({
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/rel_attention.cu",
            "replaces": f"transformer_transducer_tpu/ops/pallas/{replaces}",
            "launches": train_launches[f"{key}_bwd"],
            "max_abs_err": errs[f"{key}_bwd"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "sdpa_bd_mask_yardstick_ms": yard_ms})
    del args, leaves, out, lse, out_p, out_s, bd, add, add_band
    torch.cuda.empty_cache()

    # the flagship train step, config dropout 0.5, SpecAugment on
    for mode in ("flash", "banded", "dense"):
        model, opt, step = make_trainee(cfg.model, optim_cfg, state, mode, device)
        sa = torch.Generator().manual_seed(0)
        run = lambda: step(batch, sa)
        ms = host_ms({mode: run})[mode]
        parts = split_step(model, opt, batch, sa)
        busy = device_busy_ms(run)
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(ms)
        share = (f"{100 * (1 - busy / med):.1f} %" if busy > 0
                 else "not measured (the profiler saw no device time)")
        log(f"  train step B={B_TRAIN} ({mode}): {spread(ms)}, "
            f"{batch_audio_s * 1e3 / med:.1f} s of audio per second; split "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
            + f"; device busy {busy:.2f} ms of one step, idle share {share}; "
            f"peak memory {peak:.2f} GiB")
        del model, opt, step, run
        torch.cuda.empty_cache()

    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
