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
   the greedy loop, with the device's idle share from ``torch.profiler``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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


def attention_inputs(tlen, k_len, gen):
    """q, k, v as strided views of one fused projection (as the model hands
    them over), and tables of ``k_len`` rows sliced/front-padded to T."""
    import torch
    from transformer_transducer_tpu_torch.models.attention import slice_pos_table
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    q, k, v = mk(B, tlen, 3, H, DH).unbind(2)
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


def bound(tlen, cells):
    """Least time for the work: each input read once, the output written
    once; 2*Dh FLOP each for AC, BD and AV per live cell."""
    elems = 4 * B * tlen * H * DH + tlen * H * DH + H * DH + tlen * H
    t_bytes = 4 * elems / HBM_BYTES_PER_S
    t_ops = B * H * cells * 6 * DH / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
        Config, parse_yaml, stack_context, subsample_factor)
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

    # ---- 4. the slice at full width
    with open(os.path.join(HERE, "configs", "joint_streaming.yaml"),
              encoding="utf-8") as fh:
        cfg = Config(parse_yaml(fh.read()))
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
    banded_attention.launches = 0
    flash_rel_attention.launches = 0
    tok_band = recognize(model, x, t_len, band=band, max_tokens=max_tokens)
    tok_full = recognize(model_flash, x, t_len, max_tokens=max_tokens)
    torch.cuda.synchronize()
    launches = {"banded": banded_attention.launches,
                "flash": flash_rel_attention.launches}
    log(f"main path launches: banded {launches['banded']}, flash "
        f"{launches['flash']} (18 per encode expected)")
    n_layer = cfg.model.enc.n_layer
    require(launches == {"banded": n_layer, "flash": n_layer},
            f"the main path did not launch each kernel once a layer: {launches}")

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

    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
