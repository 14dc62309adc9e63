#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. the device: name, power limit, torch and nvcc versions;
2. build the port's CUDA kernels from ``transformer_transducer_tpu_torch/
   csrc`` (timed; one ``nvcc`` a source, all at once), with ptxas's
   registers and spills, and the ``HMMA`` (tensor-core) instructions of the
   flash forward and backward at Dh = 64 (``cuobjdump -sass``; none in
   either fails the run), and the SASS instructions and ``RED``/``ATOM``
   (atomic) instructions of the banded forward, of the banded
   backward's two kernels, of the additive logZ's four kernels, of each
   band sweep's two and of the lattice sweeps' instantiations (any atomic
   fails the run; the logZ's product must have ``HMMA``; a ``BAR`` in a
   one-warp lattice sweep fails it), with the lattice sweeps' registers and
   their launch plans (cells a lane, warps, diagonals a stage, shared
   bytes), and their branch-free log1p against log1pf on every float in
   [0, 1] (one that differs fails the run);
3. each kernel against its plain PyTorch version on the same CUDA inputs
   (atol 1e-4, rtol 1e-4), at the main path's shapes and a sweep around
   them: the additive logZ at (B, T, U1, V) = (4, 410, 43, 6485) and over
   T = 1, 17, 410, 513, U1 = 1, 6, 43, V = 37, 6485, B = 1, 4, 8, and past
   one block of label rows at U1 = 65, 129, and on spiked logits (a peak
   0-1000 nats above the rest on other symbols in A and L) with the count
   of cells its exact pass took, and two launches to the bit; the band sweeps at S = 2-8 with
   ragged t_len, a zero-length row and a clamped terminal slot, and at
   S = 33, 64, 128 (several slots a lane), each at its plan's chunks and
   at 1, 2 and 7, two of its launches to the bit and its graph replay
   equal to the eager call; the lattice sweeps at T = 1, 37, 410 and U1 =
   1, 2, 43, and at T = 37 around one warp's 32 lanes of 1, 2 and 4 cells
   (U1 = 31-33, 64, 65, 128, 129) and at U1 = 1024 (16 warps), two of their
   launches to the bit and their graph replays equal to the eager calls at
   U1 = 43, 129 and 1024; the flash forward and backward
   also at the tile edges T = 15-17, 31-33, 63-65, 127-129, the banded
   backward at bands (10, 2), (0, 0), (64, 64), (3, 64), (64, 0) and at
   the edges of its 32-row blocks and 48-row cell tiles T = 31-33, 47-49,
   95-97; the banded forward's row log-sum-exp against the band-masked
   logsumexp of the plain scores at bands (10, 2), (0, 0), (3, 64),
   (64, 0), (64, 64), as the flash forward's against the full one; the
   banded forward also at the streaming sessions' shape, T = 256 (the
   pinned window) with B = 1 and 16 at band (10, 2); the
   four attention kernels at head width 32 as well as 64;
4. the slice at full width: ``configs/joint_streaming.yaml`` (18 layers,
   d_model 512, V 6485) with seeded random weights, 8 synthetic utterances
   of 60-410 frames through the host frontend and batched greedy
   ``recognize`` — once under the streaming band (banded kernel), once
   full-context (flash kernel) — with each kernel's launch count read around
   that run; then the same through the plain versions, comparing encoder
   states (1e-3 after 18 layers) and tokens;
5. timings (medians after warm-up; CUDA events for device work, the host
   clock around synchronised calls): each kernel alone (20 launches
   captured in a CUDA graph, replayed between two events, so the wrapper's
   host time is not read; the attention forwards also at the training
   batch B = 4 with their row log-sum-exp, and two launches of the banded
   one that must agree to the bit), its plain version, its bound, the
   end-to-end ``recognize``, and that split into the encoder and the greedy
   loop, with the device's idle share from ``torch.profiler``;
6. training at full width: the same config with dropout 0, a batch of 4
   utterances (60-410 frames, 5-42 targets), 3 SGD steps (momentum 0.9,
   clip 200) with ``flash=True`` and then ``banded=True``, each with the
   launch counts read around every step (18 attention forward and 18
   backward launches, 1 alpha and 1 beta sweep), then the same steps through
   the plain versions: losses within 1e-4 and step 1's gradient norm within
   1e-3, relative;
6b. the pruned loss at full width: the same batch, ``flash=True`` with
   ``loss_pruned_range = 5`` (simple scale 0.25), 3 steps with the kernels
   (per step 1 logZ, 1 band alpha, 1 band beta, 1 alpha and 1 beta sweep,
   18 + 18 flash launches; the cells the logZ left to its exact pass), then
   3 through the plain versions at the same tolerances.  Each step's band starts are compared between the two paths;
   the plain path is handed the kernel path's starts, so a start that
   rounds the other way (an occupancy centre at .5) cannot move its loss;
6c. head width 32 end to end: ``artifacts/tone_small/config.yaml`` (2
   encoder layers, 2 heads x 32) with seeded random weights, 3 ``--flash``
   and 3 ``--banded`` steps and a ``recognize`` under the band and at full
   context, through the kernels and then the plain versions, at the
   tolerances of phases 6 and 4;
7. the training entry point: ``apps/train.py --flash`` on a synthetic corpus
   (16 train, 8 dev utterances, a 6485-symbol vocabulary) for one epoch,
   then ``-mode continue`` for a second: two checkpoints, decode dumps and a
   finite CER; ``apps/predict.py --full-context`` on the ``epoch_1``
   directory it wrote, whose text must be the trained model's greedy
   decode; then ``--flash --pruned-range 5`` for one epoch;
8. training timings: the training kernels (alone, under a CUDA graph)
   against their plain versions and bounds (the lattice sweeps also against
   their chain bound: D - 1 dependent log-add steps, one step timed alone in
   one thread, ``ttx_rnnt_lae_chain``; the logZ, its four launches in
   one graph, also against ``torch.logsumexp`` over the whole sum, with
   each launch's share and its cells through the exact pass, and the exact
   form's bound beside its own; the flash kernels, on the tensor
   cores, also against their 3xTF32 bounds, with the count of ``HMMA``
   instructions in their SASS from phase 2; the banded backward with its
   registers and atomics from phase 2, and two launches that must agree to
   the bit), and the flagship train step (config dropout 0.5) for
   ``--flash`` with the full and the pruned loss (first in turns),
   ``--banded`` and dense attention, end to end and split into phases (encoder forward, loss
   forward, backward, optimizer; for the pruned loss the simple stage,
   bounds, banded joint and band DP in place of the loss forward), with the
   device's idle share and peak memory;
9. streaming at full width: the same config and weights with phase 4's
   blank bias, two synthetic waves (410 frames, 12.27 s, and 60 frames) fed
   100 ms a call and, again, whole in one call, each then finalized,
   through a window session (windows padded to 256 rows, the ready ones
   encoded together by ``encode_banded``: 18 banded launches a group, read
   from the counters; the long wave whole in one call must take fewer
   groups than windows), a trapezoid session (one window a group) and an
   incremental session (no kernel: its 18 layers a chunk are plain tensor
   code), then the same through the plain versions; tokens identical, or
   the first frame decided differently a tie (top-2 logit gap <= 1e-3,
   replayed from the encoder rows each session decoded there under the
   label state both share), the incremental stream equal to the window
   stream and the window session's whole-file stream equal to its 100 ms
   one likewise, at most one host read an emission plus one a window, and
   ``chunked_encode`` within 1e-3 of one ``encode_banded`` over the
   sequence padded to 512; then, on the long wave, the latency of
   each ``accept_waveform`` that decoded (host clock, median and p90), the
   whole file in one call (median of 5, warm) as a real-time factor with
   the device's idle share (``torch.profiler``), host reads a window, and
   the banded forward alone under a CUDA graph at (1, 256) and (16, 256)
   with its bound; a JSON line of these before the kernels' line.

Kernel checks in phase 3: each forward against its plain version (atol
1e-4, rtol 1e-4); the attention backward against autograd through the
plain version (atol 1e-4 * max|ref| + 1e-5, rtol 1e-4: the flash
backward's shared sums are fp32 atomics in a varying order, and where a
gradient is 0 in exact
arithmetic, as every softmax gradient at T = 1, only rounding is left); the
lattice and band sweeps against the eager scans (rtol 1e-5, atol 1e-3:
log-alphas reach thousands; the band sweeps, whose chunks reassociate the
log-sums, against their eager scans run in float64, compared with both
sides clamped at NEG, where the cells no path reaches sit, and both sides
must put the same cells at or below NEG / 2).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "transformer_transducer_tpu_torch"

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): HBM
# bytes/s, float32 FLOP/s outside the tensor cores, dense TF32 tensor-core
# FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# exponentials per SM per clock of the special function units (Hopper)
SFU_PER_SM_PER_CLOCK = 16

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
S_RANGE = 5              # the pruned loss's band (--pruned-range 5)
STREAM_T = 256           # the streaming window_len at the flagship's band
STREAM_CHUNK = 1600      # 100 ms of 16 kHz audio an accept_waveform call


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


def sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


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


def graph_ms(fn, launches: int = 20, samples: int = 10) -> float:
    """A kernel alone: ``launches`` back-to-back calls of its wrapper
    captured in one CUDA graph, replayed ``samples`` times between two CUDA
    events after a warm-up; the median per launch.  The wrapper's host time
    is spent at capture, so it does not read as the kernel's."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
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


def attention_inputs(tlen, k_len, gen, b=B, dh=DH):
    """q, k, v as strided views of one fused projection (as the model hands
    them over), and tables of ``k_len`` rows sliced/front-padded to T."""
    import torch
    from transformer_transducer_tpu_torch.models.attention import slice_pos_table
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    q, k, v = mk(b, tlen, 3, H, dh).unbind(2)
    re = slice_pos_table(mk(k_len, H, dh), tlen)
    rb = slice_pos_table(mk(k_len, H), tlen)
    return q, k, v, re, mk(H, dh), rb


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


def device_top(fn, n: int = 6, calls: int = 1, unit: str = "ms") -> str:
    """The ``n`` operators and kernels with the most device time per call of
    ``fn`` over ``calls`` calls (``torch.profiler``, self device time), as
    "name time" pairs in ``unit`` ("ms" or "us")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), reverse=True,
                  key=lambda e: getattr(e, "self_device_time_total", 0))[:n]
    name = lambda key: re.sub(r"\(.*", "", key.replace("(anonymous namespace)::", ""))
    per = {"ms": 1e3, "us": 1.0}[unit] * calls
    return ", ".join(f"{name(e.key)[:48]} {getattr(e, 'self_device_time_total', 0) / per:.2f} "
                     f"{unit}" for e in rows)


def roofline(n_bytes, n_ops):
    """(least ms, "bytes" or "operations") at the card's published peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bound(tlen, cells, b=B):
    """Least time for the work: each input read once, the output written
    once; 2*Dh FLOP each for AC, BD and AV per live cell."""
    elems = 4 * b * tlen * H * DH + tlen * H * DH + H * DH + tlen * H
    return roofline(4 * elems, b * H * cells * 6 * DH)


def backward_bound(b, tlen, cells):
    """Least time for the attention backward: q, k, v, dO and the tables
    read once, dq, dk, dv and the table gradients written once; about 16*Dh
    FLOP per live cell (scores again, dp, dv, dk, dq from AC and BD, and the
    table gradient).  O and the row lse are not counted: the function does
    not need them (the Pallas kernels recompute the probabilities)."""
    elems = 7 * b * tlen * H * DH + 2 * (tlen * H * DH + H * DH + tlen * H)
    return roofline(4 * elems, b * H * cells * 16 * DH)


def backward_io_ms(b, tlen):
    """The bytes the CUDA attention backwards move as built over the memory
    rate, in ms: ``backward_bound``'s bytes and O and the row lse, which
    they read for D_i = dO_i . O_i."""
    elems = 8 * b * tlen * H * DH + b * H * tlen + 2 * (tlen * H * DH + H * DH + tlen * H)
    return 4 * elems / HBM_BYTES_PER_S * 1e3


def backward_bound_tc(b, tlen, cells):
    """The same FLOP as ``backward_bound`` done fp32-accurate as 3xTF32 (three
    TF32 tensor-core products per product) at the dense TF32 peak, in ms."""
    return 3 * b * H * cells * 16 * DH / TF32_FLOP_PER_S * 1e3


def bound_tc(cells):
    """The forward's FLOP (``bound``: 6*Dh per live cell) as 3xTF32 at the
    dense TF32 peak, in ms."""
    return 3 * B * H * cells * 6 * DH / TF32_FLOP_PER_S * 1e3


def ptxas_entries(text: str, symbol: str):
    """(registers, spill store bytes, spill load bytes) of each kernel whose
    mangled name holds ``symbol``, from ptxas's ``-v`` report."""
    out, current, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current and symbol in current:
            out.append((int(m.group(1)), *spills))
            current = None
    return out


def sass_opcodes(lib_path, symbol: str) -> collections.Counter:
    """The static count of each opcode in the SASS of the kernels whose
    mangled names hold a match of the pattern ``symbol`` (``cuobjdump
    -sass`` on the built library; a predicate guard is skipped)."""
    from transformer_transducer_tpu_torch.ops.cuda import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    count, inside = collections.Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = re.search(symbol, line) is not None
        elif inside:
            op = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
            if op:
                count[op.group(1)] += 1
    return count


def lattice_bound(b, d_total, u1, n_grids):
    """Least time for a lattice sweep: ``n_grids`` (B, D, U1) fp32 arrays
    read or written once; about 10 operations per cell (two adds and the
    log-add-exp), far below the bytes."""
    return roofline(4 * n_grids * b * d_total * u1, 10 * b * d_total * u1)


def logz_bound(b, tlen, u1, v):
    """Least time for the additive logZ in its product form: A, L read and
    logZ written once, against the product's 2 B T U1 V FLOP as 3xTF32 (three
    TF32 products a product) at the dense TF32 peak and its B (T + U1) V
    exponentials at the special function units' rate.  Beside it the exact
    form's bound, its B T U1 V exponentials, and the bytes the kernel moves
    as built over the memory rate.  All in ms, with "by" and the kernel's
    slices of V ("n_split")."""
    import torch
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    exp_rate = SFU_PER_SM_PER_CLOCK * n_sm * sm_clock_hz()
    out = {"bytes": 4 * (b * tlen * v + b * u1 * v + b * tlen * u1) / HBM_BYTES_PER_S,
           "tf32": 3 * 2 * b * tlen * u1 * v / TF32_FLOP_PER_S,
           "exp": b * (tlen + u1) * v / exp_rate,
           "exact_form": b * tlen * u1 * v / exp_rate}
    # the bytes the four launches move as built: A twice (row maxima, product),
    # L once, the split q written and read, the slices' partial sums written
    # and read, logZ written
    from transformer_transducer_tpu_torch.ops.cuda.logz_kernel import plan
    n_split = plan(0, b, tlen, u1, v)[1]
    vq = -(-v // 32) * 32
    cells = b * tlen * u1
    out["as_built"] = 4 * (2 * b * tlen * v + b * u1 * v + 4 * b * u1 * vq
                           + 2 * n_split * cells + cells) / HBM_BYTES_PER_S
    out = {k: x * 1e3 for k, x in out.items()}
    ops = max(out["tf32"], out["exp"])
    out.update(by="operations" if ops > out["bytes"] else "bytes",
               ms=max(ops, out["bytes"]), n_split=n_split)
    return out


def band_bound(b, tlen, s_range, n_arrays):
    """Least time for a band sweep: ``n_arrays`` (B, T, S) fp32 arrays and
    the (B, T) shifts read or written once; about 10 operations per cell
    and slot of the label chain, far below the bytes."""
    return roofline(4 * (n_arrays * b * tlen * s_range + b * tlen),
                    10 * b * tlen * s_range * s_range)


def band_inputs(gen, b, tlen, s_range):
    """The band sweeps' inputs as the pruned loss builds them: log-probs,
    label cells past a random u_len at NEG, monotone band starts (steps in
    [0, S)); ragged t_len with a zero-length row (when B > 1); and one row
    whose u_len the corridor cannot reach, so its terminal slot clamps at
    S - 1.  Returns (lp_b, lp_l, d_alpha, d_beta, tf, sf)."""
    import torch
    from transformer_transducer_tpu_torch.ops import rnnt_loss_pruned as rp
    rand = lambda: torch.log(torch.rand(b, tlen, s_range, generator=gen,
                                        device="cuda") * 0.95 + 0.05)
    lp_b, lp_l = rand(), rand()
    steps = torch.randint(0, s_range, (b, tlen), generator=gen, device="cuda")
    steps[:, 0] = 0
    rs = torch.cumsum(steps, dim=1)
    u_len = rs[:, -1] + torch.randint(0, s_range, (b,), generator=gen, device="cuda")
    t_len = torch.randint(1, tlen + 1, (b,), generator=gen, device="cuda")
    t_len[0] = tlen
    if b > 1:
        t_len[1] = 0
    if b > 2:
        u_len[2] += 3 * s_range
    uidx = rs[:, :, None] + torch.arange(s_range, device="cuda")
    lp_l = torch.where(uidx < u_len[:, None, None], lp_l, torch.full_like(lp_l, -1e30))
    _, tf, sf = rp._band_terminal(lp_b, rs, t_len, u_len)
    d = rs[:, 1:] - rs[:, :-1]
    pad = torch.nn.functional.pad
    return lp_b, lp_l, pad(d, (1, 0)), pad(d, (0, 1)), tf, sf


def spiked_logits(gen, b, tlen, u1, v, margin):
    """randn * 3 logits (B, T, V) and (B, U1, V) with a peak ``margin`` nats
    above the row maximum on symbol 3 in about half the rows of A and on
    symbol 7 in about half those of L; and the cells whose rows both peak
    (on different symbols: the logZ's product form underflows there)."""
    import torch
    a = torch.randn(b, tlen, v, generator=gen, device="cuda") * 3
    l = torch.randn(b, u1, v, generator=gen, device="cuda") * 3
    sa = torch.rand(b, tlen, generator=gen, device="cuda") < 0.5
    sl = torch.rand(b, u1, generator=gen, device="cuda") < 0.5
    sa[0, 0] = sl[0, 0] = True
    a[..., 3] = torch.where(sa, a.amax(-1) + margin, a[..., 3])
    l[..., 7] = torch.where(sl, l.amax(-1) + margin, l[..., 7])
    return a, l, sa[:, :, None] & sl[:, None, :]


def check_pruned_kernels(gen):
    """Phase 3, the pruned loss's kernels: the additive logZ against its
    plain version (atol 1e-4, rtol 1e-4) at the flagship shape and a sweep
    (U1 to 129), on spiked logits (with the cells its exact pass took) and
    two launches to the bit, the band sweeps against theirs in float64 (rtol
    1e-5, atol 1e-3) at S = 2-8 and 33, 64, 128 (with both sides clamped at
    NEG and the same cells at or below NEG / 2, at the plan's chunks and at
    1, 2 and 7; two launches of each to the bit and its graph replay equal
    to the eager call); returns the largest abs error of each."""
    import torch
    from transformer_transducer_tpu_torch.ops.cuda import band_kernel as bk
    from transformer_transducer_tpu_torch.ops.cuda.band_kernel import (
        band_alpha, band_alpha_plain, band_alpha_plan, band_beta, band_beta_plain)
    from transformer_transducer_tpu_torch.ops.cuda import logz_kernel as lk
    from transformer_transducer_tpu_torch.ops.cuda.logz_kernel import (
        additive_logz, additive_logz_plain)
    errs = {"logz": 0.0, "band_alpha": 0.0, "band_beta": 0.0}
    log("additive logZ vs plain (atol 1e-4, rtol 1e-4):")
    shapes = [(B_TRAIN, T_MAIN, 43, 6485)]
    for i, (tlen, u1, v) in enumerate((tlen, u1, v) for tlen in (1, 17, 410, 513)
                                      for u1 in (1, 6, 43) for v in (37, 6485)):
        shapes.append(((1, 4, 8)[i % 3], tlen, u1, v))
    # past one block of 64 label rows
    shapes += [(2, 37, 65, 6485), (B_TRAIN, T_MAIN, 65, 6485), (2, 17, 129, 300)]
    worst = []
    for b, tlen, u1, v in shapes:
        a = torch.randn(b, tlen, v, generator=gen, device="cuda") * 3
        l = torch.randn(b, u1, v, generator=gen, device="cuda") * 3
        with torch.no_grad():
            got, ref = additive_logz(a, l), additive_logz_plain(a, l)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, **KERNEL_TOL,
                                   msg=f"logZ B={b} T={tlen} U1={u1} V={v}")
        errs["logz"] = max(errs["logz"], err)
        worst.append((err, (b, tlen, u1, v)))
    log(f"  flagship (4, 410, 43, 6485): max|err| {worst[0][0]:.3e}; "
        f"{len(shapes)} shapes, worst {max(worst)[0]:.3e} at (B, T, U1, V) = "
        f"{max(worst)[1]}")
    log("additive logZ on spiked logits (a peak margin nats above the row's "
        "maximum on symbol 3 in about half the rows of A, on symbol 7 in half "
        "those of L), cells left to the exact pass:")
    for b, tlen, u1, v in ((B_TRAIN, T_MAIN, 43, 6485), (2, 70, 65, 37), (2, 19, 6, 131)):
        line = []
        for margin in (0, 30, 55, 62, 100, 1000):
            a, l, both = spiked_logits(gen, b, tlen, u1, v, margin)
            with torch.no_grad():
                got = additive_logz(a, l)
                marked = lk.marked_cells()
                ref = additive_logz_plain(a, l)
            torch.testing.assert_close(got, ref, **KERNEL_TOL,
                                       msg=f"spiked logZ {margin} nats B={b} T={tlen} "
                                           f"U1={u1} V={v}")
            errs["logz"] = max(errs["logz"], (got - ref).abs().max().item())
            n_both = int(both.sum())
            require(marked == 0 if margin <= 30 else marked <= n_both,
                    f"logZ at {margin} nats: {marked} cells marked, {n_both} peak twice")
            require(margin < 100 or marked == n_both > 0,
                    f"logZ at {margin} nats: {marked} cells marked, {n_both} peak twice")
            line.append(f"{margin} nats {marked}/{n_both}")
        log(f"  (B, T, U1, V) = ({b}, {tlen}, {u1}, {v}), {b * tlen * u1} cells; marked / "
            f"peaked twice: " + ", ".join(line) + f"; max|err| so far {errs['logz']:.3e}")
    a, l, _ = spiked_logits(gen, B_TRAIN, T_MAIN, 43, 6485, 100)
    with torch.no_grad():
        first, again = additive_logz(a, l), additive_logz(a, l)
    require(torch.equal(first, again), "two launches of the additive logZ differ")
    log(f"  two launches at (4, 410, 43, 6485), 100 nats ({lk.marked_cells()} cells "
        f"through the exact pass): bit-identical")
    log(f"band sweeps vs plain in float64 (rtol {LATTICE_TOL['rtol']}, atol "
        f"{LATTICE_TOL['atol']}; ragged t_len, a zero-length row, a clamped "
        f"terminal slot; both sides clamped at NEG and equal cells at or below "
        f"NEG / 2, at the plan's chunks and at 1, 2 and 7):")
    # S past 32 takes several slots a lane; its plain sweep is slow (a step
    # per slot and row), so most of those run at a short T
    sweeps = [(s_range, (1, 37, T_MAIN)) for s_range in range(2, 9)]
    sweeps += [(33, (1, 37, T_MAIN)), (64, (1, 37)), (128, (1, 37))]
    for s_range, lengths in sweeps:
        line = []
        for tlen in lengths:
            lp_b, lp_l, d_a, d_b, tf, sf = band_inputs(gen, B_TRAIN, tlen, s_range)
            # the plain sweeps in float64: in float32 their own rounding
            # grows with the log-alphas and log-betas (1.7x and 0.9x the
            # tolerance at S 128, T 410)
            refs = {"band_alpha": band_alpha_plain(lp_b.double(), lp_l.double(), d_a).float(),
                    "band_beta": band_beta_plain(lp_b.double(), lp_l.double(), d_b, tf,
                                                 sf).float()}
            plan = f"the plan's {band_alpha_plan(tlen, s_range)}"
            runs = [("band_alpha", plan, band_alpha(lp_b, lp_l, d_a, s_range)),
                    ("band_beta", plan, band_beta(lp_b, lp_l, d_b, tf, sf, s_range))]
            for n in (1, 2, 7):
                runs += [("band_alpha", str(n), bk._launch_alpha(lp_b, lp_l, d_a, n)),
                         ("band_beta", str(n), bk._launch_beta(lp_b, lp_l, d_b, tf, sf, n))]
            torch.cuda.synchronize()
            for name, chunks, got in runs:
                what = f"{name} S={s_range} T={tlen}, {chunks} chunks"
                ref = refs[name]
                # cells no path reaches sit at or below NEG: compared, and
                # the error read, with both sides clamped there
                torch.testing.assert_close(got.clamp(min=-1e30), ref.clamp(min=-1e30),
                                           **LATTICE_TOL, msg=what)
                require(torch.equal(got <= -5e29, ref <= -5e29),
                        f"{what}: the cells at or below NEG / 2 differ")
                err = (got.clamp(min=-1e30) - ref.clamp(min=-1e30)).abs().max()
                errs[name] = max(errs[name], err.item())
            line.append(f"T={tlen}")
        log(f"  S={s_range} ({', '.join(line)}): max|err| so far alpha "
            f"{errs['band_alpha']:.3e}, beta {errs['band_beta']:.3e}")
    # the chunked sweeps: two launches to the bit, a graph's replay equal to
    # the eager call
    lp_b, lp_l, d_a, d_b, tf, sf = band_inputs(gen, B_TRAIN, T_MAIN, S_RANGE)
    for name, run in (("band alpha", lambda: band_alpha(lp_b, lp_l, d_a, S_RANGE)),
                      ("band beta", lambda: band_beta(lp_b, lp_l, d_b, tf, sf, S_RANGE))):
        first, again = run(), run()
        require(torch.equal(first, again), f"two launches of the {name} differ")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = run()
        graph.replay()
        torch.cuda.synchronize()
        require(torch.equal(replayed, first), f"the {name}'s graph replay differs")
        del graph
        log(f"  {name} at ({B_TRAIN}, {T_MAIN}, {S_RANGE}), "
            f"{band_alpha_plan(T_MAIN, S_RANGE)} chunks: two launches bit-identical, the "
            f"graph replay equal to the eager call")
    return errs


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
    # around one warp's 32 lanes of 1, 2 and 4 cells, several warps, the most
    shapes += [(B_TRAIN, 37, u) for u in (30, 31, 32, 63, 64, 127, 128, 1023)]
    shapes += [(B_TRAIN, T_MAIN, 128)]
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
    for tlen, u in ((T_MAIN, 42), (T_MAIN, 128), (37, 1023)):
        sb, sl, inject = lattice_inputs(B_TRAIN, tlen, u, gen)
        for name, run in (("alpha", lambda: alpha_scan(sb, sl)),
                          ("beta", lambda: beta_scan(sb, sl, inject))):
            first, again = run(), run()
            require(torch.equal(first, again), f"two launches of the {name} sweep differ")
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = run()
            graph.replay()
            torch.cuda.synchronize()
            require(torch.equal(replayed, first), f"the {name} sweep's graph replay differs")
            del graph
        log(f"  T={tlen} U={u}: each sweep's two launches bit-identical, its graph replay "
            f"equal to the eager call")

    log(f"attention backward vs autograd through the plain versions (atol "
        f"{GRAD_TOL} * max|ref| + {GRAD_FLOOR}, rtol {GRAD_TOL}):")
    names = ("out", "dq", "dk", "dv", "d_r_emb", "d_r_w_bias", "d_r_bias")
    # the flash backward also at the edges of its 32-row query tiles and
    # 64-key chunks
    cases = [(tlen, band) for tlen in (1, 37, 410, 513)
             for band in (None, (10, 2), (0, 0), (64, 64))]
    cases += [(tlen, band) for tlen in (1, 37, 410, 513) for band in ((3, 64), (64, 0))]
    cases = [(tlen, band, DH) for tlen, band in cases]
    cases += [(tlen, None, DH) for tlen in (15, 16, 17, 31, 32, 33, 63, 64, 65, 127,
                                             128, 129)]
    # the banded backward at the edges of its 32-row blocks and 48-row cell
    # tiles
    cases += [(tlen, band, DH) for tlen in (31, 32, 33, 47, 48, 49, 95, 96, 97)
              for band in ((10, 2), (3, 64), (64, 0))]
    # head width 32
    cases += [(tlen, band, 32) for tlen in (1, 33, 129, 410) for band in (None, (10, 2))]
    for tlen, band, dh in cases:
        mk = lambda *s: (torch.randn(*s, generator=gen, device="cuda")
                         * 0.5).requires_grad_()
        leaves = [mk(B_TRAIN, tlen, 3, H, dh), mk(T_MAIN, H, dh), mk(H, dh),
                  mk(T_MAIN, H)]
        gout = torch.randn(B_TRAIN, tlen, H, dh, generator=gen, device="cuda")
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
        log(f"  {label} Dh={dh} T={tlen:3d}: " + ", ".join(line))
    return errs


@contextlib.contextmanager
def plain_versions():
    """Route the attention, lattice, logZ and band wrappers to their plain
    versions on the card (the comparisons' reference path; the logZ's
    gradient then comes from autograd through the plain version)."""
    from transformer_transducer_tpu_torch.ops import rnnt_loss
    from transformer_transducer_tpu_torch.ops import rnnt_loss_pruned as rp
    from transformer_transducer_tpu_torch.ops.cuda import banded_attention as ba
    from transformer_transducer_tpu_torch.ops.cuda import band_kernel as bk
    from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
    from transformer_transducer_tpu_torch.ops.cuda import logz_kernel as lk
    from transformer_transducer_tpu_torch.ops.cuda import rnnt_kernel as rk
    saved = (ba.banded_attention, fa.flash_rel_attention, rnnt_loss.alpha_scan,
             rnnt_loss.beta_scan, rp.additive_logz, rp.band_alpha, rp.band_beta)
    ba.banded_attention = ba.banded_attention_plain
    fa.flash_rel_attention = fa.flash_rel_attention_plain
    rnnt_loss.alpha_scan, rnnt_loss.beta_scan = rk.alpha_scan_plain, rk.beta_scan_plain
    rp.additive_logz = lambda a, l: lk.additive_logz_plain(a.float(), l.float())
    rp.band_alpha = lambda lp_b, lp_l, d, s_range: bk.band_alpha_plain(lp_b, lp_l, d)
    rp.band_beta = lambda lp_b, lp_l, d, tf, sf, s_range: bk.band_beta_plain(
        lp_b, lp_l, d, tf, sf)
    try:
        yield
    finally:
        (ba.banded_attention, fa.flash_rel_attention, rnnt_loss.alpha_scan,
         rnnt_loss.beta_scan, rp.additive_logz, rp.band_alpha, rp.band_beta) = saved


@contextlib.contextmanager
def band_starts(record, force=None):
    """Append each pruned step's band starts ``rs`` to ``record``; with
    ``force`` (another run's records), hand the loss the starts of that
    run's same step instead of its own."""
    from transformer_transducer_tpu_torch.ops import rnnt_loss_pruned as rp
    original = rp.bounds_from_occ

    def hooked(*args):
        rs = original(*args)
        record.append(rs)
        return rs if force is None else force[len(record) - 1]

    rp.bounds_from_occ = hooked
    try:
        yield
    finally:
        rp.bounds_from_occ = original


@contextlib.contextmanager
def logz_marks(record):
    """Append, after each logZ call of the pruned loss, the cells the kernel
    left to its exact pass (a read of the device after the call)."""
    from transformer_transducer_tpu_torch.ops import rnnt_loss_pruned as rp
    from transformer_transducer_tpu_torch.ops.cuda.logz_kernel import marked_cells
    original = rp.additive_logz

    def hooked(a_grid, l_grid):
        z = original(a_grid, l_grid)
        record.append(marked_cells())
        return z

    rp.additive_logz = hooked
    try:
        yield
    finally:
        rp.additive_logz = original


@functools.lru_cache(maxsize=None)
def counters():
    """The launch counters of every kernel wrapper, by name (the wrappers
    themselves, read before ``plain_versions`` can swap them out)."""
    from transformer_transducer_tpu_torch.ops.cuda import banded_attention as ba
    from transformer_transducer_tpu_torch.ops.cuda import band_kernel as bk
    from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
    from transformer_transducer_tpu_torch.ops.cuda import logz_kernel as lk
    from transformer_transducer_tpu_torch.ops.cuda import rnnt_kernel as rk
    return {"banded_fwd": ba.banded_attention, "banded_bwd": ba.banded_attention_backward,
            "flash_fwd": fa.flash_rel_attention,
            "flash_bwd": fa.flash_rel_attention_backward,
            "alpha": rk.alpha_scan, "beta": rk.beta_scan,
            "logz": lk.additive_logz, "band_alpha": bk.band_alpha,
            "band_beta": bk.band_beta}


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


def make_trainee(model_cfg, optim_cfg, state, mode, device, pruned_range=None):
    """A model in train mode with ``state``, its SGD optimizer (momentum,
    clip 200 as the trainer builds it) and its train step (SpecAugment on;
    the pruned loss with simple scale 0.25 when ``pruned_range``)."""
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.training.optim import build_optimizer
    from transformer_transducer_tpu_torch.training.train_step import (
        TrainStepConfig, make_train_step)
    model = build_transducer(model_cfg, flash=mode == "flash",
                             banded=mode == "banded", device=device)
    model.load_state_dict(state)
    model.train()
    opt = build_optimizer(optim_cfg, list(model.parameters()), max_grad_norm=200.0)
    cfg = TrainStepConfig(loss_pruned_range=pruned_range)
    return model, opt, make_train_step(model, opt, cfg)


def train_three_steps(model_cfg, optim_cfg, state, mode, batch, device, plain,
                      pruned_range=None, hooks=()):
    """Phases 6 and 6b: 3 steps from ``state`` with the SpecAugment stream
    seeded alike, inside the contexts ``hooks``; per step (loss, raw
    gradient norm, launch counts)."""
    import torch
    model, opt, step = make_trainee(model_cfg, optim_cfg, state, mode, device,
                                    pruned_range)
    gen = torch.Generator().manual_seed(0)
    out = []
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(plain_versions())
        for hook in hooks:
            stack.enter_context(hook)
        for _ in range(3):
            reset_counts()          # the main path: counts from 0, read after
            m = step(batch, gen)
            torch.cuda.synchronize()
            out.append((float(m["loss"]), float(m["grad_norm"]), read_counts()))
    return out


def check_streaming_shapes(gen) -> float:
    """The banded forward against its plain version at the streaming
    sessions' shape: T pinned at STREAM_T, one window or a group of 16;
    returns the largest abs error."""
    import torch
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention, banded_attention_plain)
    worst = 0.0
    for b in (1, 16):
        args = attention_inputs(STREAM_T, 410, gen, b=b)
        got = banded_attention(*args, *BAND)
        ref = banded_attention_plain(*args, *BAND)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        log(f"  banded Dh={DH} B={b} T={STREAM_T} band=({BAND[0]},{BAND[1]}): max|err| "
            f"{err:.3e}")
        torch.testing.assert_close(got, ref, **KERNEL_TOL)
        worst = max(worst, err)
    return worst


def check_kernels(gen):
    """Phase 3: the attention forward kernels against their plain versions,
    with their row log-sum-exps against the logsumexp of the plain scores
    (band-masked for the banded forward); returns the largest abs error of
    each."""
    import torch
    from transformer_transducer_tpu_torch.models.attention import rel_attention_scores
    from transformer_transducer_tpu_torch.ops.cuda import common
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention, banded_attention_plain)
    from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
        flash_rel_attention_plain)
    from transformer_transducer_tpu_torch.ops.masks import context_mask
    errs = {"banded": 0.0, "flash": 0.0}
    # the banded forward at the edges of its 32-row blocks and of the 47
    # keys an offset chunk stages; 513 > k_len: front pad.  The wrapper
    # (no lse) and a launch with the lse must give the same output bits.
    for dh in (DH, 32):
        for tlen in (1, 33, 37, 49, 129, 410, 513):
            for band in ((10, 2), (0, 0), (3, 64), (64, 0), (64, 64)):
                args = attention_inputs(tlen, 410, gen, dh=dh)
                got = banded_attention(*args, *band)
                with_lse, lse, _ = common.launch_forward("ttx_banded_attention_fwd", args,
                                                         band, with_lse=True)
                ref = banded_attention_plain(*args, *band)
                scores = rel_attention_scores(*args[:2], *args[3:]).masked_fill(
                    context_mask(tlen, *band, device="cuda"), float("-inf"))
                lse_ref = torch.logsumexp(scores, -1)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                err_lse = (lse - lse_ref).abs().max().item()
                log(f"  banded Dh={dh} T={tlen:4d} band=({band[0]},{band[1]}): max|err| "
                    f"{err:.3e}, lse {err_lse:.3e}")
                torch.testing.assert_close(got, ref, **KERNEL_TOL)
                torch.testing.assert_close(lse, lse_ref, **KERNEL_TOL)
                require(torch.equal(got, with_lse),
                        f"banded T={tlen} band={band}: the output moved with the lse")
                errs["banded"] = max(errs["banded"], err, err_lse)
    errs["banded"] = max(errs["banded"], check_streaming_shapes(gen))
    # the flash forward (on the tensor cores) at the edges of its 128-row
    # query tiles and 32-key chunks, with its row log-sum-exp; 513 > k_len:
    # front pad
    for dh in (DH, 32):
        for tlen in (1, 15, 16, 17, 31, 32, 33, 37, 63, 64, 65, 127, 128, 129,
                     410, 513):
            args = attention_inputs(tlen, 410, gen, dh=dh)
            got, lse, _ = common.launch_forward("ttx_flash_rel_attention_fwd", args, (),
                                                with_lse=True)
            ref = flash_rel_attention_plain(*args)
            lse_ref = torch.logsumexp(rel_attention_scores(*args[:2], *args[3:]), -1)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            log(f"  flash  Dh={dh} T={tlen:4d}: max|err| {err:.3e}, lse {err_lse:.3e}")
            torch.testing.assert_close(got, ref, **KERNEL_TOL)
            torch.testing.assert_close(lse, lse_ref, **KERNEL_TOL)
            errs["flash"] = max(errs["flash"], err, err_lse)
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


def load_config(*path):
    """A config of the repo (path under its root) as a port ``Config``."""
    from transformer_transducer_tpu_torch.utils.config import Config, parse_yaml
    with open(os.path.join(HERE, *path), encoding="utf-8") as fh:
        return Config(parse_yaml(fh.read()))


def load_flagship():
    """``configs/joint_streaming.yaml`` as a port ``Config``."""
    return load_config("configs", "joint_streaming.yaml")


def feed_stream(session, wave, chunk=STREAM_CHUNK):
    """Feed ``wave`` to ``session`` ``chunk`` samples a call (all of it in
    one call where ``chunk`` is None), then finalize; the host ms around
    each ``accept_waveform`` that decoded a window, and the tokens each of
    those calls emitted."""
    import torch
    lat, emitted = [], []
    chunk = chunk or len(wave)
    for i in range(0, len(wave), chunk):
        before = session.windows
        start = time.perf_counter()
        new = session.accept_waveform(wave[i:i + chunk])
        torch.cuda.synchronize()
        if session.windows > before:
            lat.append((time.perf_counter() - start) * 1e3)
            emitted.append(len(new))
    session.finalize()
    torch.cuda.synchronize()
    return lat, emitted


def record_windows(session):
    """Have ``session`` keep the encoder rows its frame decoder is given,
    as (first absolute frame, rows) in ``session.window_rows``, so that a
    tie can be replayed after the stream."""
    rows = session.window_rows = []
    decode = session._frame_decode

    def recorded(enc_eff, abs_start):
        rows.append((abs_start, enc_eff.clone()))
        return decode(enc_eff, abs_start)
    session._frame_decode = recorded
    return session


def replay_gap(session, tokens, frame) -> float:
    """The top-2 logit gap at absolute ``frame`` of ``session``'s stream,
    from the encoder row its frame decoder was given there (the last, if
    more than one) under the label state of ``tokens``: the seed and the
    last ``label_history`` of them, as the session's ring holds them."""
    import torch
    from transformer_transducer_tpu_torch.decoding.greedy import predict_last_state
    from transformer_transducer_tpu_torch.ops.masks import look_ahead_mask
    model, cfg = session.model, session.cfg
    start, rows = next((a, r) for a, r in reversed(session.window_rows)
                       if a <= frame < a + r.shape[0])
    cap = cfg.label_history + 1
    hist = [cfg.seed_token] + tokens[len(tokens) - min(len(tokens), cfg.label_history):]
    buf = torch.zeros((1, cap), dtype=torch.long, device=rows.device)
    buf[0, :len(hist)] = torch.tensor(hist, device=rows.device)
    with torch.no_grad():
        dec = predict_last_state(model, buf, len(hist), look_ahead_mask(cap, device=rows.device))
        top = model.joint_logits(rows[frame - start][None], dec)[0].topk(2).values
    return float(top[0] - top[1])


def compare_streams(name, got, ref):
    """Two sessions' token streams must be identical; where they are not,
    the first frame they decide differently must be a tie under the label
    state both still share (top-2 logit gap <= GAP_TOL in either, replayed
    from the rows each decoded there), else the run fails."""
    a = list(zip(got.timestamps, got.result))
    b = list(zip(ref.timestamps, ref.result))
    if a == b:
        log(f"  {name}: tokens identical ({len(a)} tokens, {len(got.segments)} segments)")
        return
    u = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    frame = min(s[u][0] for s in (a, b) if u < len(s))
    gap = max(replay_gap(s, s.result[:u], frame) for s in (got, ref))
    log(f"  {name}: token {u} first differs at frame {frame}, top-2 logit gap {gap:.3e}")
    require(gap <= GAP_TOL, f"{name}: streams diverge at frame {frame} (gap {gap:.3e})")


def check_streaming(cfg, state, offset, device, smi, gen):
    """Phase 9: the streaming sessions at full width.  Returns the kernel
    record's additions for kernel 6 and the phase's summary."""
    import numpy as np
    import torch
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention, banded_attention_plain)
    from transformer_transducer_tpu_torch.streaming.session import (
        StreamingConfig, StreamingSession, TrapezoidStreamingSession, chunked_encode)
    model = build_transducer(cfg.model, device=device)
    model.load_state_dict(state)
    with torch.no_grad():
        model.joint.project_layer.bias[0] += offset       # phase 4's bias
    n_layer = cfg.model.enc.n_layer
    left, right = cfg.model.enc.left_context, cfg.model.enc.right_context
    all_waves = synthetic_waves(8, seed=0)
    waves = {"long": all_waves[-1], "short": all_waves[0]}
    feeds = {"100 ms": STREAM_CHUNK, "whole file": None}
    modes = ("window", "trapezoid", "incremental")

    def session(mode, keep=False):
        scfg = StreamingConfig.from_config(cfg)
        if mode == "trapezoid":
            return TrapezoidStreamingSession(model, scfg, device=device)
        return StreamingSession(model, scfg, device=device, keep_features=keep,
                                incremental=mode == "incremental")

    scfg = StreamingConfig.from_config(cfg)
    scfg.ensure_lengths()
    log(f"streaming sessions at full width, {STREAM_CHUNK * 1000 // 16000} ms a call "
        f"and the whole file in one call (window_len {scfg.window_len}, chunk_len "
        f"{scfg.chunk_len}):")
    # the main path, each wave, feed and mode with the counts from 0; then
    # the same sessions through the plain versions
    kern, plain, stream_launches = {}, {}, 0
    for wname, wave in waves.items():
        for fname, chunk in feeds.items():
            for mode in modes:
                s = record_windows(session(mode, keep=mode == "window"))
                reset_counts()
                feed_stream(s, wave, chunk)
                counts = read_counts()
                want = dict.fromkeys(counts, 0)
                if mode != "incremental":
                    want["banded_fwd"] = n_layer * s.window_groups
                what = f"{mode}, {wname} ({len(wave) / 16000:.2f} s), {fname}"
                log(f"  {what}: {len(s.result)} tokens, {len(s.segments)} segments, "
                    f"{s.windows} windows in {s.window_groups} groups, {s.host_reads} host "
                    f"reads ({s.host_reads / s.windows:.2f} a window); launches {counts}")
                require(counts == want, f"{what}: launches {counts}, want {want}")
                require(s.host_reads <= len(s.result) + s.windows,
                        f"{what}: {s.host_reads} host reads")
                require(s.result and 0 not in s.result and len(s.timestamps) == len(s.result)
                        and all(np.isfinite(s.confidences)), f"{what}: malformed output")
                if mode == "window" and chunk is None and wname == "long":
                    # the windows one call finds ready are encoded together
                    require(s.window_groups < s.windows,
                            f"{what}: {s.windows} windows in {s.window_groups} groups")
                stream_launches += counts["banded_fwd"]
                kern[wname, fname, mode] = s
            with plain_versions():
                for mode in modes:
                    s = record_windows(session(mode))
                    reset_counts()
                    feed_stream(s, wave, chunk)
                    require(not any(read_counts().values()), f"plain {mode} launched")
                    plain[wname, fname, mode] = s
            for mode in modes:
                compare_streams(f"{mode}, {wname}, {fname}, kernel vs plain",
                                kern[wname, fname, mode], plain[wname, fname, mode])
            compare_streams(f"incremental vs window, {wname}, {fname}",
                            kern[wname, fname, "incremental"], kern[wname, fname, "window"])
        compare_streams(f"window, {wname}, whole file vs 100 ms",
                        kern[wname, "whole file", "window"], kern[wname, "100 ms", "window"])

    # chunked_encode against one encode_banded over the padded sequence
    feats = kern["long", "100 ms", "window"].feature_log
    fixed = 512
    padded = torch.zeros((1, fixed, feats.shape[1]), device=device)
    padded[0, :len(feats)] = torch.from_numpy(feats)
    with torch.no_grad():
        full = model.encode_banded(padded, left, right)[0, :len(feats)].cpu().numpy()
    chunked = chunked_encode(model, feats, scfg, fixed_len=fixed)
    require(chunked.shape == full.shape and np.isfinite(chunked).all(),
            "chunked_encode: wrong shape or not finite")
    err = float(np.abs(chunked - full).max())
    log(f"  chunked_encode ({len(feats)} frames, windows padded to {fixed}) vs "
        f"encode_banded over the padded sequence: max|err| {err:.3e} (tolerance {ENC_TOL})")
    require(err <= ENC_TOL, f"chunked_encode differs by {err}")

    # timings: latency per decoding call at 100 ms a call, the whole file
    # in one call (median of 5, warm), the device's idle share of that
    log(f"streaming timings on {smi}:")
    summary = {}
    wave = waves["long"]
    audio_s = len(wave) / 16000.0
    for mode in modes:
        s = session(mode)
        feed_stream(s, wave)                                    # warm-up
        s.reset()
        lat, emitted = feed_stream(s, wave)

        def whole(s=s):
            s.reset()
            s.accept_waveform(wave)
            s.finalize()
        ms = host_ms({mode: whole}, samples=5)[mode]
        med = statistics.median(ms)
        busy = device_busy_ms(whole)
        checked, at_once = kern["long", "100 ms", mode], kern["long", "whole file", mode]
        summary[mode] = {
            "latency_ms_median": statistics.median(lat),
            "latency_ms_p90": float(np.percentile(lat, 90)), "decoding_calls": len(lat),
            "latency_ms_calls": [round(x, 2) for x in lat], "tokens_calls": emitted,
            "whole_file_ms": med, "rtf": med / 1e3 / audio_s,
            "device_busy_ms": busy, "idle_share": 1 - busy / med if busy > 0 else None,
            "host_reads_per_window": checked.host_reads / checked.windows,
            "windows": checked.windows, "groups": checked.window_groups,
            "windows_whole_file": at_once.windows, "groups_whole_file": at_once.window_groups}
        r = summary[mode]
        share = (f"{100 * r['idle_share']:.1f} %" if busy > 0
                 else "not measured (the profiler saw no device time)")
        log(f"  {mode}: latency per decoding call median {r['latency_ms_median']:.2f} ms, "
            f"p90 {r['latency_ms_p90']:.2f} ms (calls {r['latency_ms_calls']}, tokens "
            f"{emitted}); whole file "
            f"({audio_s:.2f} s) in one call {spread(ms)}, real-time factor {r['rtf']:.5f}; "
            f"device busy {busy:.2f} ms, idle share {share}; host reads a window "
            f"{r['host_reads_per_window']:.2f}; the whole file's {at_once.windows} windows "
            f"in {at_once.window_groups} groups")
    # kernel 6 alone at the window length, one window and a group of 16
    rec = {"streaming_launches": stream_launches}
    for b in (1, 16):
        args = attention_inputs(STREAM_T, 410, gen, b=b)
        with torch.no_grad():
            ms = graph_ms(lambda: banded_attention(*args, left, right))
        plain_ms = cuda_ms(lambda: banded_attention_plain(*args, left, right))
        bound_ms, by = bound(STREAM_T, band_cells(STREAM_T, left, right), b=b)
        rec.update({f"ms_t{STREAM_T}_b{b}": ms, f"plain_ms_t{STREAM_T}_b{b}": plain_ms,
                    f"bound_t{STREAM_T}_b{b}_ms": bound_ms})
        log(f"  banded_attention_fwd (B={b}, T={STREAM_T}): kernel {ms:.4f} ms (alone, CUDA "
            f"graph), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({by}), "
            f"{100 * bound_ms / ms:.1f} % of bound")
    del model
    torch.cuda.empty_cache()
    return rec, summary


def check_head_width_32(device):
    """Phase 6c: ``artifacts/tone_small/config.yaml`` (2 heads x 32) with
    seeded random weights: 3 ``--flash`` and 3 ``--banded`` steps through the
    kernels and through the plain versions (losses within 1e-4, step 1's
    gradient norm within 1e-3, relative; 2 attention forward and 2 backward
    launches a step), then ``recognize`` under the band and at full context
    against the plain path (encoder states within 1e-3, tokens identical or
    a tie)."""
    import torch
    from transformer_transducer_tpu_torch.decoding.greedy import recognize
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.ops.masks import context_mask
    from transformer_transducer_tpu_torch.utils.config import Config
    from transformer_transducer_tpu_torch.utils.convert import (
        from_jax_params, random_jax_params)
    cfg = load_config("artifacts", "tone_small", "config.yaml")
    require(cfg.model.enc.d_head == 32, "the tone config is not at head width 32")
    n_layer = cfg.model.enc.n_layer
    state = from_jax_params(random_jax_params(cfg.model, seed=0))
    optim_cfg = Config({"type": "sgd", "lr": cfg.optim.lr, "momentum": 0.9})
    batch, _ = training_batch(cfg, device, seed=2)
    log(f"head width 32 ({cfg.model.enc.n_layer} encoder layers, "
        f"{cfg.model.enc.n_head} heads x {cfg.model.enc.d_head}): batch of {B_TRAIN}, "
        f"frames {batch['inputs_length'].tolist()}")
    for mode in ("flash", "banded"):
        kern = train_three_steps(cfg.model, optim_cfg, state, mode, batch, device,
                                 plain=False)
        plain = train_three_steps(cfg.model, optim_cfg, state, mode, batch, device,
                                  plain=True)
        want = dict.fromkeys(read_counts(), 0)
        want.update({f"{mode}_fwd": n_layer, f"{mode}_bwd": n_layer}, alpha=1, beta=1)
        for i, ((lk, nk, ck), (lp, norm_p, cp)) in enumerate(zip(kern, plain)):
            rel = abs(lk - lp) / abs(lp)
            log(f"  Dh 32 {mode} step {i + 1}: loss kernel {lk:.6f} / plain {lp:.6f} "
                f"(rel {rel:.2e}), grad norm {nk:.5f} / {norm_p:.5f}")
            require(ck == want, f"Dh 32 {mode} step {i + 1}: launches {ck}, want {want}")
            require(not any(cp.values()), f"Dh 32 {mode} plain step launched {cp}")
            require(rel <= LOSS_RTOL, f"Dh 32 {mode} step {i + 1}: losses differ by {rel:.2e}")
        rel = abs(kern[0][1] - plain[0][1]) / abs(plain[0][1])
        log(f"  Dh 32 {mode}: step 1 grad norm rel diff {rel:.2e} (tolerance {NORM_RTOL})")
        require(rel <= NORM_RTOL, f"Dh 32 {mode}: step 1 grad norms differ by {rel:.2e}")

    models = {}
    for flash in (False, True):
        models[flash] = build_transducer(cfg.model, flash=flash, device=device)
        models[flash].load_state_dict(state)
    x, t_len = batch["inputs"], batch["inputs_length"].cpu().numpy()
    tlen = x.shape[1]
    band = (cfg.model.enc.left_context, cfg.model.enc.right_context)
    max_tokens = cfg.data.max_target_length + 1
    mask = context_mask(tlen, *band, device=device)
    reset_counts()
    toks = {"band": recognize(models[False], x, t_len, band=band, max_tokens=max_tokens),
            "full-context": recognize(models[True], x, t_len, max_tokens=max_tokens)}
    torch.cuda.synchronize()
    counts = read_counts()
    require(counts["banded_fwd"] == n_layer and counts["flash_fwd"] == n_layer,
            f"Dh 32 recognize did not run the attention kernels once a layer: {counts}")
    toks_p = {"band": recognize(models[False], x, t_len, audio_mask=mask,
                                max_tokens=max_tokens),
              "full-context": recognize(models[False], x, t_len, max_tokens=max_tokens)}
    with torch.no_grad():
        encs = {"band": (models[False].encode_banded(x, *band), models[False].encode(x, mask)),
                "full-context": (models[True].encode(x), models[False].encode(x))}
    for name, (enc_k, enc_p) in encs.items():
        err = (enc_k - enc_p).abs().max().item()
        log(f"  Dh 32 {name}: encoder states kernel vs plain max|err| {err:.3e} "
            f"(tolerance {ENC_TOL})")
        require(bool(torch.isfinite(enc_k).all()) and err <= ENC_TOL,
                f"Dh 32 {name}: encoder states differ by {err}")
        compare_tokens(f"Dh 32 {name}", toks[name], toks_p[name], models[False],
                       enc_k, enc_p, t_len, max_tokens)


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


def split_pruned_step(model, opt, batch, gen, samples: int = 5) -> dict:
    """Median host ms of a pruned train step's phases (``--pruned-range
    5``, simple scale 0.25), each ended by a synchronise: encoder forward,
    simple stage (linearized grids, logZ, the alpha and beta sweeps), bounds
    (the band starts' clip scan), banded joint, band DP (alpha sweep and
    loss), backward, optimizer."""
    import torch
    from transformer_transducer_tpu_torch.ops import rnnt_loss_pruned as rp
    from transformer_transducer_tpu_torch.ops.rnnt_loss import joint_params
    from transformer_transducer_tpu_torch.ops.specaug import spec_augment
    from transformer_transducer_tpu_torch.training.optim import global_norm
    from transformer_transducer_tpu_torch.training.train_step import TrainStepConfig
    cfg = TrainStepConfig(loss_pruned_range=S_RANGE)
    names = ("encoder forward", "simple stage", "bounds", "banded joint",
             "band DP", "backward", "optimizer")
    times = {n: [] for n in names}
    labels = batch["targets"]
    for r in range(samples + 1):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        model.train()
        for p in opt.params:
            p.grad = None
        x = spec_augment(gen, batch["inputs"], cfg.max_mask_time,
                         cfg.max_mask_frequency, cfg.mask_num)
        enc, dec = model.encode_both(x, labels)
        mark()
        jp = joint_params(model)
        t_len = torch.clamp(batch["inputs_length"], max=enc.shape[1])
        u_len = torch.clamp(batch["targets_length"], max=dec.shape[1] - 1)
        sp_b, sp_l = rp.simple_grid_logprobs(enc, dec, jp, labels)
        simple, occ = rp.simple_loss_and_occ(sp_b, sp_l, t_len, u_len)
        mark()
        rs = rp.bounds_from_occ(occ, t_len, u_len, S_RANGE)
        mark()
        lp_b, lp_l = rp.banded_grid_logprobs(enc, dec, jp, labels, rs, u_len, S_RANGE,
                                             chunk_size=cfg.loss_chunk_size)
        mark()
        loss = (rp.rnnt_loss_banded(lp_b, lp_l, rs, t_len, u_len)
                + cfg.loss_simple_scale * simple).mean()
        mark()
        loss.backward()
        mark()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in opt.params]
        global_norm(grads)
        opt.step(grads)
        mark()
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
    from transformer_transducer_tpu_torch.data.wav import read_wave
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
    ptxas = lib_path.with_name(lib_path.stem + ".ptxas.txt").read_text()
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            log("  ptxas:", line.strip())
    # the flash kernels' products run on the tensor cores (mma.sync); Dh 64
    tc = {}
    for name, symbol in (("flash forward", "flash_fwd_tcILi64E"),
                         ("flash backward", "flash_bwd_tcILi64E")):
        ops = sass_opcodes(lib_path, symbol)
        (regs, spill_st, spill_ld), = ptxas_entries(ptxas, symbol)
        tc[name] = {"hmma": ops["HMMA"], "sass": sum(ops.values()), "registers": regs,
                    "spill_bytes": spill_st + spill_ld}
        log(f"  {name} ({symbol}): {ops['HMMA']} HMMA of {sum(ops.values())} "
            f"instructions in its SASS, {regs} registers, {spill_st} + {spill_ld} bytes "
            f"of spill stores + loads; most: "
            + ", ".join(f"{op} {n}" for op, n in ops.most_common(12)))
        require(ops["HMMA"] > 0, f"the {name} has no tensor-core instruction")
    # the banded forward and backward (SIMT, Dh 64): no atomic instruction
    # in the forward or in either of the backward's two kernels
    simt = {}
    for symbol in ("banded_fwdILi64E", "banded_bwdILi64E", "banded_bwd_tablesILi64E"):
        ops = sass_opcodes(lib_path, symbol)
        (regs, spill_st, spill_ld), = ptxas_entries(ptxas, symbol)
        atomics = sum(n for op, n in ops.items() if op.startswith(("RED", "ATOM")))
        simt[symbol] = {"sass": sum(ops.values()), "registers": regs,
                        "spill_bytes": spill_st + spill_ld, "atomics": atomics}
        log(f"  banded attention ({symbol}): {sum(ops.values())} instructions in its "
            f"SASS, {atomics} RED/ATOM, {regs} registers, {spill_st} + {spill_ld} "
            f"bytes of spill stores + loads; most: "
            + ", ".join(f"{op} {n}" for op, n in ops.most_common(12)))
        require(atomics == 0, f"the banded attention's {symbol} has atomics")
    # the additive logZ's four kernels: no atomic in any of them, the
    # product (U1 43 -> NT 6, 16-byte copies) on the tensor cores
    ops = sass_opcodes(lib_path, "logz_")
    prod = sass_opcodes(lib_path, "logz_productILi6EE")
    (regs, spill_st, spill_ld), = ptxas_entries(ptxas, "logz_productILi6EE")
    atomics = sum(n for op, n in ops.items() if op.startswith(("RED", "ATOM")))
    logz_sass = {"hmma": prod["HMMA"], "sass": sum(prod.values()), "registers": regs,
                 "spill_bytes": spill_st + spill_ld, "atomics": atomics}
    log(f"  additive logZ (logz_*): {sum(ops.values())} SASS instructions in its four "
        f"kernels' instantiations, {atomics} RED/ATOM; the product at NT 6: "
        f"{prod['HMMA']} HMMA of {sum(prod.values())}, {regs} registers, {spill_st} + "
        f"{spill_ld} bytes of spill stores + loads")
    require(atomics == 0, "the additive logZ's kernels have atomics")
    require(prod["HMMA"] > 0, "the additive logZ's product has no tensor-core instruction")
    # each band sweep's two kernels (every slot-register count; the beta's
    # instantiations are <NS, true>): no atomic
    band_sass = {}
    for name, beta in (("band_alpha", 0), ("band_beta", 1)):
        ops = sass_opcodes(lib_path, rf"band_(transfer|rows)ILi\dELb{beta}EE")
        (regs_a, *_), (regs_c, *_) = (ptxas_entries(ptxas, f"{k}ILi1ELb{beta}EE")[0]
                                      for k in ("band_transfer", "band_rows"))
        atomics = sum(n for op, n in ops.items() if op.startswith(("RED", "ATOM")))
        band_sass[name] = {"sass": sum(ops.values()), "atomics": atomics,
                           "registers": [regs_a, regs_c]}
        log(f"  {name} (band_transfer, band_rows): {sum(ops.values())} SASS instructions "
            f"in their instantiations, {atomics} RED/ATOM; {regs_a} and {regs_c} registers "
            f"at one slot a lane")
        require(ops and atomics == 0, f"the {name}'s kernels have atomics or no SASS")

    # the lattice sweeps (wavefront<K, MULTI, BETA>): no atomic in any
    # instantiation, no barrier in the one-warp forms (MULTI false)
    ops = sass_opcodes(lib_path, "wavefront")
    one_warp = sass_opcodes(lib_path, r"wavefrontILi\dELb0E")
    atomics = sum(n for op, n in ops.items() if op.startswith(("RED", "ATOM")))
    barriers = sum(n for op, n in one_warp.items() if op.startswith("BAR"))
    lattice_sass = {"sass": sum(ops.values()), "atomics": atomics,
                    "one_warp_barriers": barriers, "registers": {}}
    for k, multi in ((1, 0), (2, 0), (4, 0), (2, 1)):      # one warp; several
        for beta in (0, 1):
            (regs, spill_st, spill_ld), = ptxas_entries(
                ptxas, f"wavefrontILi{k}ELb{multi}ELb{beta}EE")
            lattice_sass["registers"][f"K{k}{'_warps' if multi else ''}"
                                      f"{'_beta' if beta else '_alpha'}"] = regs
    from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import plan as lattice_plan
    log(f"  lattice sweeps (wavefront): {sum(ops.values())} SASS instructions in their "
        f"instantiations, {atomics} RED/ATOM, {barriers} BAR in the one-warp forms; "
        f"registers {lattice_sass['registers']}; at U1 43 alpha "
        f"{lattice_plan(43, False)}, beta {lattice_plan(43, True)}; at U1 1024 beta "
        f"{lattice_plan(1024, True)}")
    require(ops and atomics == 0, "the lattice sweeps have atomics or no SASS")
    require(one_warp and barriers == 0, "the one-warp lattice sweeps have a barrier")
    from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import log1p_mismatches
    bad = log1p_mismatches()
    log(f"  lattice sweeps' branch-free log1p against log1pf over every float in [0, 1]: "
        f"{bad} differ")
    require(bad == 0, f"the lattice sweeps' log1p differs from log1pf on {bad} floats")

    # ---- 3. kernels vs plain versions
    log("kernels vs plain versions (atol 1e-4, rtol 1e-4):")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_kernels(gen)
    errs.update(check_training_kernels(gen))
    errs.update(check_pruned_kernels(gen))

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
    want = dict.fromkeys(counts, 0)
    want.update(banded_fwd=n_layer, flash_fwd=n_layer)
    require(counts == want,
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
    from transformer_transducer_tpu_torch.ops.cuda import common
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
         band_cells(T_MAIN, *band), "ttx_banded_attention_fwd", band),
        ("flash_rel_attention_fwd", "flash",
         "transformer_transducer_tpu/ops/pallas/flash_rel_attention.py:248",
         lambda: flash_rel_attention(*args),
         lambda: flash_rel_attention_plain(*args),
         lambda: sdpa(qh, kh, vh, attn_mask=add),
         T_MAIN * T_MAIN, "ttx_flash_rel_attention_fwd", ()),
    )
    args4 = attention_inputs(T_MAIN, 410, gen, b=B_TRAIN)
    for name, key, replaces, kern, plain, yard, cells, fn, extra in rows:
        with torch.no_grad():
            ms = graph_ms(kern)
        plain_ms, yard_ms = cuda_ms(plain), cuda_ms(yard)
        bound_ms, bound_by = bound(T_MAIN, cells)
        # also at the training batch, with the row lse, as a training step
        # runs it
        fwd4 = lambda: common.launch_forward(fn, args4, extra, with_lse=True)[:2]
        ms_b4 = graph_ms(fwd4)
        bound_b4, _ = bound(T_MAIN, cells, b=B_TRAIN)
        rec = {"name": name, "route": "cuda",
               "source": f"{PKG}/csrc/rel_attention.cu", "replaces": replaces,
               "launches": launches[key], "max_abs_err": errs[key], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "sdpa_bd_mask_yardstick_ms": yard_ms,
               "share_of_bound": bound_ms / ms, "ms_b4": ms_b4, "bound_b4_ms": bound_b4,
               "share_of_bound_b4": bound_b4 / ms_b4}
        note = (f"; at B={B_TRAIN} with the lse {ms_b4:.4f} ms, bound {bound_b4:.4f} ms, "
                f"{100 * bound_b4 / ms_b4:.1f} % of it")
        if key == "banded":     # SIMT, no atomics: two launches bit-identical
            first, again = fwd4(), fwd4()
            same = all(torch.equal(x, y) for x, y in zip(first, again))
            require(same, "two launches of the banded forward differ")
            del first, again
            fwd = simt["banded_fwdILi64E"]
            rec.update(registers=fwd["registers"], spill_bytes=fwd["spill_bytes"],
                       sass=fwd["sass"], atomics=fwd["atomics"], deterministic=same)
            note += (f"; {rec['registers']} registers, {rec['spill_bytes']} bytes of "
                     f"spills, {rec['sass']} SASS instructions, {rec['atomics']} atomics, "
                     f"two launches bit-identical")
        if key == "flash":      # on the tensor cores: its 3xTF32 bound too
            rec.update(source=f"{PKG}/csrc/flash_rel_attention_fwd.cu",
                       bound_tc_ms=bound_tc(cells), **tc["flash forward"])
            rec["share_of_bound_tc"] = rec["bound_tc_ms"] / ms
            note = (f", 3xTF32 bound {rec['bound_tc_ms']:.4f} ms, "
                    f"{100 * rec['share_of_bound_tc']:.1f} % of it; "
                    f"{rec['hmma']} HMMA, {rec['registers']} registers" + note)
        log(f"  {name}: kernel {ms:.4f} ms (alone, CUDA graph), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, fp32), {100 * bound_ms / ms:.1f} % of "
            f"bound{note}; SDPA with BD as a precomputed mask (yardstick) {yard_ms:.4f} ms")
        records.append(rec)
    del args4

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

    # ---- 6b. the pruned loss at full width (--flash --pruned-range 5): the
    # kernels, then the plain versions handed the kernel run's band starts
    rs_kern, rs_plain, pruned_marks = [], [], []
    kern = train_three_steps(model_cfg0, optim_cfg, state, "flash", batch, device,
                             plain=False, pruned_range=S_RANGE,
                             hooks=(band_starts(rs_kern), logz_marks(pruned_marks)))
    plain = train_three_steps(model_cfg0, optim_cfg, state, "flash", batch, device,
                              plain=True, pruned_range=S_RANGE,
                              hooks=(band_starts(rs_plain, force=rs_kern),))
    want = dict.fromkeys(train_launches, 0)
    want.update(per_step["flash"], alpha=1, beta=1, logz=1, band_alpha=1, band_beta=1)
    pruned_launches = dict.fromkeys(train_launches, 0)
    for i, ((lk, nk, ck), (lp, norm_p, cp)) in enumerate(zip(kern, plain)):
        rel = abs(lk - lp) / abs(lp)
        differ = int((rs_kern[i] != rs_plain[i]).sum())
        note = " (the plain loss used the kernel path's)" if differ else ""
        log(f"  flash, pruned {S_RANGE}, step {i + 1}: loss kernel {lk:.6f} / plain "
            f"{lp:.6f} (rel {rel:.2e}), grad norm {nk:.5f} / {norm_p:.5f}; band "
            f"starts: {differ} of {rs_kern[i].numel()} cells differ between the "
            f"paths{note}; logZ cells through its exact pass {pruned_marks[i]}; "
            f"launches {ck}")
        require(ck == want, f"pruned step {i + 1}: launches {ck}, want {want}")
        require(not any(cp.values()), f"pruned plain step launched {cp}")
        require(rel <= LOSS_RTOL, f"pruned step {i + 1}: losses differ by {rel:.2e}")
        for name, n in ck.items():
            train_launches[name] += n
            pruned_launches[name] += n
    rel = abs(kern[0][1] - plain[0][1]) / abs(plain[0][1])
    log(f"  flash, pruned {S_RANGE}: step 1 grad norm rel diff {rel:.2e} (tolerance "
        f"{NORM_RTOL})")
    require(rel <= NORM_RTOL, f"pruned: step 1 grad norms differ by {rel:.2e}")
    rs0 = rs_kern[0]
    require(bool((rs0[:, 0] == 0).all()) and bool((rs0.diff(dim=1) >= 0).all())
            and bool((rs0.diff(dim=1) < S_RANGE).all()),
            "the band starts break their invariants")
    del rs_kern, rs_plain

    # ---- 6c. head width 32 end to end
    check_head_width_32(device)

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
        # the recognition entry point on the checkpoint training wrote, and
        # its loader's weights against the trained model's
        from transformer_transducer_tpu_torch.apps import predict as predict_app
        from transformer_transducer_tpu_torch.models.factory import load_family
        from transformer_transducer_tpu_torch.utils.config import load_config as load_cfg_file
        from transformer_transducer_tpu_torch.utils.vocab import Vocabulary
        cli_cfg = load_cfg_file(cfg_path)
        with open(cli_cfg.data.dev, encoding="utf-8") as fh:
            wav = fh.read().splitlines()[1].split(",")[0]
        reset_counts()
        text = predict_app.main(["--config", cfg_path, "--checkpoint",
                                 os.path.join(exp, "epoch_1"), "--wav", wav,
                                 "--full-context"])
        torch.cuda.synchronize()
        pred_counts = read_counts()
        wave, rate = read_wave(wav)
        feats = F.subsample(F.stack_frames(F.logmel_masked(wave, rate, n_mels),
                                           left_ctx, right_ctx), subsample_factor(cfg.data))
        second.model.eval()
        loaded = load_family(cli_cfg, feats.shape[1], os.path.join(exp, "epoch_1"),
                             device=device, flash=True)
        require(all(torch.equal(a, b) for a, b in zip(second.model.state_dict().values(),
                                                      loaded.state_dict().values())),
                "predict's loader did not restore the trained weights")
        del loaded
        tokens = recognize(second.model, torch.from_numpy(feats[None]).to(device),
                           [feats.shape[0]], max_tokens=max_tokens)[0]
        want_text = "".join(Vocabulary.from_file(cli_cfg.data.vocab).decode(tokens))
        log(f"apps/predict.py --full-context on epoch_1: {len(text)} characters, "
            f"launches {pred_counts}; its loader restored the trained weights; the "
            f"trained model's greedy decode {'matches' if text == want_text else 'differs'}")
        require(text == want_text, f"predict gave {text!r}, the trained model {want_text!r}")
        require(pred_counts["flash_fwd"] == n_layer,
                f"predict did not run the flash forward once a layer: {pred_counts}")
        # the pruned loss through the entry point, one epoch
        os.chdir(tmp)
        try:
            reset_counts()
            start = time.perf_counter()
            third = train_app.main(["-config", cfg_path, "--flash", "--pruned-range",
                                    str(S_RANGE), "--epochs", "1",
                                    "--set", "training.save_model=pruned"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - start
            cli_counts = read_counts()
        finally:
            os.chdir(cwd)
        exp = os.path.join(tmp, third.exp_dir)
        with open(os.path.join(exp, "metrics.jsonl"), encoding="utf-8") as fh:
            rows = [r for r in map(json.loads, fh)]
        cers = [r["value"] for r in rows if r["tag"] == "cer"]
        losses = [r["value"] for r in rows if r["tag"] == "train_loss"]
        log(f"apps/train.py --flash --pruned-range {S_RANGE}: 1 epoch in {cli_s:.1f} s, "
            f"{third.global_step} steps, train losses {losses}, CER {cers}, "
            f"launches {cli_counts}")
        require(third.step_cfg.loss_pruned_range == S_RANGE and third.global_step == 4,
                f"pruned CLI: {third.step_cfg}, {third.global_step} steps")
        require(os.path.exists(os.path.join(exp, "epoch_0", "model.pt"))
                and len(cers) == 1 and all(np.isfinite(cers + losses)),
                f"pruned CLI: no checkpoint, or CER {cers} / losses {losses}")
        require(all(cli_counts[k] == 4 for k in ("logz", "band_alpha", "band_beta"))
                and cli_counts["flash_bwd"] == 4 * n_layer,
                f"the pruned entry point did not run its kernels once a step: {cli_counts}")
        del first, second, third
    torch.cuda.empty_cache()

    # ---- 8. training timings (B=4, T=410, H=8, Dh=64)
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
    # the chain's step alone: one thread, dependent x = lae(x + c, y)
    from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import lae_chain
    n_chain = 20 * (d_total - 1)
    cy = torch.tensor([0.0, -0.5, -1.0], device="cuda")
    chain_step_ms = cuda_ms(lambda: lae_chain(cy, n_chain), samples=10, reps=3) / n_chain
    chain_ms = (d_total - 1) * chain_step_ms
    log(f"  the chain's step (one thread, {n_chain} dependent x = lae(x + c, y)): "
        f"{1e6 * chain_step_ms:.2f} ns; chain bound for {d_total - 1} diagonals "
        f"{chain_ms:.4f} ms")
    for name, key, replaces, kern, plain, n_grids in (
            ("rnnt_alpha", "alpha", "rnnt_kernel.py:158",
             lambda: alpha_scan(sb, sl), lambda: alpha_scan_plain(sb, sl), 3),
            ("rnnt_beta", "beta", "rnnt_kernel.py:190",
             lambda: beta_scan(sb, sl, inject),
             lambda: beta_scan_plain(sb, sl, inject), 4)):
        ms, plain_ms = graph_ms(kern), cuda_ms(plain, samples=5, reps=2)
        bound_ms, bound_by = lattice_bound(B_TRAIN, d_total, u1, n_grids)
        log(f"  {name} (B={B_TRAIN}, D={d_total}, U1={u1}): kernel {ms:.4f} ms "
            f"({1e3 * ms / (d_total - 1):.3f} us per dependent diagonal), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), chain bound "
            f"{chain_ms:.4f} ms ({100 * chain_ms / ms:.1f} % of it), "
            f"{train_launches[key] // 9} launch per step")
        records.append({
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/rnnt_lattice.cu",
            "replaces": f"transformer_transducer_tpu/ops/pallas/{replaces}",
            "launches": train_launches[key], "max_abs_err": errs[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "chain_bound_ms": chain_ms,
            "registers": {k: r for k, r in lattice_sass["registers"].items()
                          if k.endswith(key)}})

    # the pruned loss's kernels at the flagship training shapes
    from transformer_transducer_tpu_torch.ops.cuda.band_kernel import (
        band_alpha, band_alpha_plain, band_alpha_plan, band_beta, band_beta_plain,
        band_chain)
    from transformer_transducer_tpu_torch.ops.cuda.logz_kernel import (
        additive_logz, additive_logz_plain, marked_cells)
    u1, vocab = cfg.data.max_target_length + 1, cfg.model.vocab_size
    a = torch.randn(B_TRAIN, T_MAIN, vocab, generator=gen, device="cuda") * 3
    l = torch.randn(B_TRAIN, u1, vocab, generator=gen, device="cuda") * 3
    with torch.no_grad():
        # the four launches of a call in one graph, 20 calls
        ms = graph_ms(lambda: additive_logz(a, l))
        marked = marked_cells()
        launch_split = device_top(lambda: additive_logz(a, l), n=4, calls=20, unit="us")
        plain_ms = cuda_ms(lambda: additive_logz_plain(a, l), samples=5, reps=2)
        # library yardstick, never called by the port: one PyTorch call over
        # the whole (B, T, U1, V) sum (1.8 GB)
        lib_ms = cuda_ms(lambda: torch.logsumexp(a[:, :, None] + l[:, None], dim=-1),
                         samples=5, reps=2)
    # the logZ's backward (plain PyTorch, a loop over U1), as the pruned
    # step's simple-loss term runs it
    a.requires_grad_()
    l.requires_grad_()
    z = additive_logz(a, l)
    g = torch.randn_like(z)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(z, (a, l), g, retain_graph=True),
                     samples=5, reps=2)
    del z, g
    lb = logz_bound(B_TRAIN, T_MAIN, u1, vocab)
    log(f"  additive_logz (B={B_TRAIN}, T={T_MAIN}, U1={u1}, V={vocab}): kernel "
        f"{ms:.4f} ms (its four launches, alone, CUDA graph), plain {plain_ms:.4f} ms, "
        f"torch.logsumexp over the whole sum (library) {lib_ms:.4f} ms, bound "
        f"{lb['ms']:.4f} ms ({lb['by']}: bytes {lb['bytes']:.4f} ms, 3xTF32 product "
        f"{lb['tf32']:.4f} ms, exponentials {lb['exp']:.4f} ms at "
        f"{SFU_PER_SM_PER_CLOCK}/SM/clock and {sm_clock_hz() / 1e6:.0f} MHz), "
        f"{100 * lb['ms'] / ms:.1f} % of bound; its bytes as built ({lb['n_split']} "
        f"slices of V) {lb['as_built']:.4f} ms; the exact form's bound (its "
        f"exponentials) {lb['exact_form']:.4f} ms; cells through the exact pass "
        f"{marked} here, {pruned_marks} in phase 6b's steps; per launch (profiler, "
        f"eager): {launch_split}; {logz_sass['hmma']} HMMA, {logz_sass['registers']} "
        f"registers, {logz_sass['atomics']} atomics; {pruned_launches['logz'] // 3} call "
        f"per pruned step; its backward (plain, {u1} passes over (B, T, V)) "
        f"{bwd_ms:.4f} ms")
    records.append({
        "name": "additive_logz", "route": "cuda", "source": f"{PKG}/csrc/additive_logz.cu",
        "replaces": "transformer_transducer_tpu/ops/pallas/logz_kernel.py:58",
        "launches": pruned_launches["logz"], "max_abs_err": errs["logz"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": lb["ms"], "bound_by": lb["by"],
        "library_ms": lib_ms, "kernels_per_launch": 4, "share_of_bound": lb["ms"] / ms,
        "bound_tc_ms": lb["tf32"], "exact_form_bound_ms": lb["exact_form"],
        "io_as_built_ms": lb["as_built"], "n_split": lb["n_split"],
        "marked_cells": marked, "marked_cells_pruned_steps": pruned_marks,
        "backward_plain_ms": bwd_ms, **logz_sass})
    del a, l
    lp_b, lp_l, d_a, d_b, tf, sf = band_inputs(gen, B_TRAIN, T_MAIN, S_RANGE)
    n_chunks = band_alpha_plan(T_MAIN, S_RANGE)
    # the beta's chain is its longest sequence's: rows tf .. 0
    chain = {"band_alpha": band_chain(T_MAIN, n_chunks, S_RANGE),
             "band_beta": band_chain(int(tf.max()) + 1, n_chunks, S_RANGE)}
    for name, replaces, kern, plain, n_arrays in (
            ("band_alpha", "band_kernel.py:181",
             lambda: band_alpha(lp_b, lp_l, d_a, S_RANGE),
             lambda: band_alpha_plain(lp_b, lp_l, d_a), 3),
            ("band_beta", "band_kernel.py:215",
             lambda: band_beta(lp_b, lp_l, d_b, tf, sf, S_RANGE),
             lambda: band_beta_plain(lp_b, lp_l, d_b, tf, sf), 3)):
        ms, plain_ms = graph_ms(kern), cuda_ms(plain, samples=5, reps=2)
        bound_ms, bound_by = band_bound(B_TRAIN, T_MAIN, S_RANGE, n_arrays)
        rec = {"name": name, "route": "cuda", "source": f"{PKG}/csrc/rnnt_pruned.cu",
               "replaces": f"transformer_transducer_tpu/ops/pallas/{replaces}",
               "launches": pruned_launches[name], "max_abs_err": errs[name], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "chain_steps": chain[name],
               "us_per_chain_step": 1e3 * ms / chain[name], "n_chunks": n_chunks,
               "kernels_per_launch": 1 + (n_chunks > 1), **band_sass[name]}
        log(f"  {name} (B={B_TRAIN}, T={T_MAIN}, S={S_RANGE}): kernel {ms:.4f} ms, "
            f"{chain[name]} dependent steps on its chain ({rec['us_per_chain_step']:.3f} "
            f"us a step), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
            f"{pruned_launches[name] // 3} call per pruned step; {n_chunks} chunks "
            f"(band_alpha_plan), {rec['atomics']} atomics, registers {rec['registers']}")
        records.append(rec)

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
    for name, key, fn, bwd, plain_fn, extra, mask_add, cells, replaces, source in (
            ("banded_attention_bwd", "banded", "ttx_banded_attention_fwd",
             banded_attention_backward, banded_attention_plain, band, add_band,
             band_cells(T_MAIN, *band), "banded_attention.py:346",
             "banded_attention_bwd.cu"),
            ("flash_rel_attention_bwd", "flash", "ttx_flash_rel_attention_fwd",
             flash_rel_attention_backward, flash_rel_attention_plain, (), add,
             T_MAIN * T_MAIN, "flash_rel_attention.py:288",
             "flash_rel_attention_bwd.cu")):
        out, lse, _ = common.launch_forward(fn, args, tuple(extra), with_lse=True)
        out_p = plain_fn(*leaves, *extra)
        # yardstick only: SDPA's backward on q, k, v with BD as a
        # precomputed additive mask (no table gradients); never in the port
        out_s = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask_add)
        ms = graph_ms(lambda: bwd(*args, out, lse, gout, *extra))
        plain_ms = cuda_ms(lambda: torch.autograd.grad(out_p, leaves, gout,
                                                       retain_graph=True))
        yard_ms = cuda_ms(lambda: torch.autograd.grad(
            out_s, (qh, kh, vh), gout.transpose(1, 2), retain_graph=True))
        bound_ms, bound_by = backward_bound(B_TRAIN, T_MAIN, cells)
        rec = {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{source}",
               "replaces": f"transformer_transducer_tpu/ops/pallas/{replaces}",
               "launches": train_launches[f"{key}_bwd"],
               "max_abs_err": errs[f"{key}_bwd"], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
               "sdpa_bd_mask_yardstick_ms": yard_ms}
        note = ""
        if key == "banded":     # SIMT, no atomics: two launches bit-identical
            first = bwd(*args, out, lse, gout, *extra)
            again = bwd(*args, out, lse, gout, *extra)
            same = all(torch.equal(x, y) for x, y in zip(first, again))
            require(same, "two launches of the banded backward differ")
            del first, again
            main, tables = simt["banded_bwdILi64E"], simt["banded_bwd_tablesILi64E"]
            rec.update(kernels_per_launch=2, io_as_built_ms=backward_io_ms(B_TRAIN, T_MAIN),
                       share_of_bound=bound_ms / ms, registers=main["registers"],
                       spill_bytes=main["spill_bytes"], sass=main["sass"],
                       atomics=main["atomics"] + tables["atomics"],
                       tables_registers=tables["registers"], tables_sass=tables["sass"],
                       deterministic=same)
            split = device_top(lambda: bwd(*args, out, lse, gout, *extra), n=2, calls=20,
                               unit="us")
            note = (f"; its bytes as built (with O and lse) {rec['io_as_built_ms']:.4f} ms; "
                    f"{rec['registers']} registers, {rec['sass']} SASS instructions, "
                    f"{rec['atomics']} atomics, two launches bit-identical; two kernels "
                    f"a launch: {split}")
        if key == "flash":      # on the tensor cores: its 3xTF32 bound too
            rec.update(bound_tc_ms=backward_bound_tc(B_TRAIN, T_MAIN, cells),
                       share_of_bound=bound_ms / ms, **tc["flash backward"])
            rec["share_of_bound_tc"] = rec["bound_tc_ms"] / ms
            note = (f", 3xTF32 bound {rec['bound_tc_ms']:.4f} ms, "
                    f"{100 * rec['share_of_bound_tc']:.1f} % of it; {rec['hmma']} HMMA, "
                    f"{rec['registers']} registers")
        log(f"  {name}: kernel {ms:.4f} ms (alone, CUDA graph), plain (autograd) "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, fp32), "
            f"{100 * bound_ms / ms:.1f} % of bound{note}; SDPA backward with BD as a "
            f"precomputed mask (yardstick) {yard_ms:.4f} ms; {n_layer} launches per step")
        records.append(rec)
    del args, leaves, out, lse, out_p, out_s, bd, add, add_band
    torch.cuda.empty_cache()

    # the flagship train step, config dropout 0.5, SpecAugment on; first the
    # full and the pruned loss with --flash in turns, then each mode alone
    pair = {}
    for name, pruned_range in (("flash", None), (f"flash, pruned {S_RANGE}", S_RANGE)):
        step = make_trainee(cfg.model, optim_cfg, state, "flash", device,
                            pruned_range)[2]
        sa = torch.Generator().manual_seed(0)
        pair[name] = functools.partial(step, batch, sa)
    for name, ms in host_ms(pair).items():
        log(f"  train step B={B_TRAIN} ({name}), the two in turns: {spread(ms)}")
    del pair, step
    torch.cuda.empty_cache()
    for mode, pruned_range in (("flash", None), ("flash", S_RANGE), ("banded", None),
                               ("dense", None)):
        model, opt, step = make_trainee(cfg.model, optim_cfg, state, mode, device,
                                        pruned_range)
        if pruned_range:
            mode = f"flash, pruned {S_RANGE}"
        sa = torch.Generator().manual_seed(0)
        run = lambda: step(batch, sa)
        ms = host_ms({mode: run})[mode]
        parts = (split_pruned_step if pruned_range else split_step)(model, opt, batch, sa)
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
        if mode.startswith("flash"):
            log(f"    most device time in one step: {device_top(run)}")
        del model, opt, step, run
        torch.cuda.empty_cache()

    # ---- 9. streaming at full width
    stream_rec, streaming = check_streaming(cfg, state, offset, device, smi, gen)
    next(r for r in records if r["name"] == "banded_attention_fwd").update(stream_rec)
    log(json.dumps({"streaming": streaming}))

    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
