"""The benchmark's driver: one cell, one seed, one window.

Everything that belongs to one cell, configuration, traffic mix, entry
kind, per-layer metric or piece of kernel work is a file of its own, found
by the name ``BENCHMARK.json`` gives:

* the cell's entry in ``BENCHMARK.json``: its configuration and traffic
  names, its chips and its ``why``;
* ``workloads/<cell>.json``: the limits of the comparison that decides
  ``correct``;
* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the entry kind and the parameters of the
  traffic generator (``mix.py``);
* ``entries/<kind>.py``: ``setup``, ``window`` and ``check`` of a kind of
  work (``train``, ``recognize``);
* ``metrics/<metric>.py``: ``read(run)``, a per-layer metric from the
  traced window, or None where it finds nothing to read;
* ``work/<piece>.py``: ``count(run)``, the operations and bytes a piece of
  kernel work needs, and ``work/patterns/<piece>.*.txt``, the profiler's
  kernel names (regular expressions, one a line) that do that work.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "transformer_transducer_tpu")

# One NVIDIA H100 SXM's published dense peaks at its 700 W limit: TF32 on
# the tensor cores (no float32-accurate path beats it; the port's float32
# attention kernels run 3xTF32 on them) and HBM3.  The SIMT float32 rate,
# 67 TFLOP/s, bounds no work here.
PEAK_FLOP_PER_S = 495e12
PEAK_BYTES_PER_S = 3.35e12


def load_json(kind: str, name: str) -> Dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark_file() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark must not
    load (whole names: ``transformer_transducer_tpu_torch`` is allowed)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Spans:
    """Host-clock spans of the benchmark's own calls into the program,
    each ending in a synchronise, kept only in a traced run."""

    def __init__(self, on: bool, device):
        self.on, self.device, self.times = on, device, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function("bench." + name):
            t0 = time.perf_counter()
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.times.setdefault(name, []).append(time.perf_counter() - t0)


@dataclasses.dataclass
class Context:
    cell: str
    workload: Dict
    cfg: Dict
    traffic: Dict
    seed: int
    device: torch.device
    spans: Spans
    control: bool = False                  # also read the control (benchmark/control.py)
    readings: Optional[Dict] = None        # the control's readings


@dataclasses.dataclass
class Run:
    """What the per-layer metrics and the work counts read."""
    ctx: Context
    records: List[Dict]
    window_s: float
    busy_s: float = 0.0
    kernels: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0

    def kernel_seconds(self, piece: str) -> Optional[float]:
        """Device seconds of the kernels that do ``piece``; None where no
        kernel of it ran."""
        files = sorted((HERE / "work" / "patterns").glob(piece + ".*.txt"))
        patterns = [line.strip() for f in files for line in f.read_text().splitlines()
                    if line.strip()]
        hits = [s for name, s in self.kernels.items()
                if any(re.search(p, name) for p in patterns)]
        return sum(hits) if hits else None

    def roofline_pct(self, *pieces: str) -> Optional[float]:
        """The least time of the pieces' work at the peaks over the device
        time of their kernels, in %; None where a piece has no work or no
        kernel."""
        least, spent = 0.0, 0.0
        for piece in pieces:
            counted = load_module("work", piece).count(self)
            seconds = self.kernel_seconds(piece)
            if not counted or seconds is None:
                return None
            least += sum(max(f / PEAK_FLOP_PER_S, b / PEAK_BYTES_PER_S) for f, b in counted)
            spent += seconds
        return 100.0 * least / spent


class tf32:
    """TF32 products on the card inside the block (the control's
    precision), full float32 after it."""

    def __enter__(self):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def reduce_trace(prof, window_name: str = "bench.window"):
    """(busy_s, kernels {name: s}, breakdown) of a profiled window: the
    union of the device activities inside the window span, the kernels'
    summed time by name, the ten kernels with most time and the ten host
    operations that most idle time fell under (the innermost host event
    open at each idle gap's middle)."""
    from torch.autograd import DeviceType
    dev, host, window = [], [], None
    events = prof.profiler.kineto_results.events()
    # a record_function range shows on the device timeline too, under its
    # host name: it is no device activity
    host_names = {e.name() for e in events if e.device_type() != DeviceType.CUDA}
    for e in events:
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        end = start + (e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000)
        if e.device_type() == DeviceType.CUDA:
            if e.name() not in host_names:
                dev.append((start, end, e.name()))
        else:
            host.append((start, end, e.name()))
            if e.name() == window_name:
                window = (start, end)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    lo, hi = window
    dev = sorted((max(s, lo), min(e, hi), n) for s, e, n in dev if e > lo and s < hi)
    kernels: Dict[str, float] = {}
    busy, cur_s, cur_e, gaps = 0, lo, lo, []
    for s, e, n in dev:
        kernels[n] = kernels.get(n, 0.0) + (e - s) / 1e9
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((cur_e, hi))
    host.sort()
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith("bench.") and h[2] != window_name]
    span_starts = [h[0] for h in spans]
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        # the innermost host event open at the gap's middle: among the last
        # few to start, else the benchmark's span around it
        label = next((host[j][2] for j in range(i, max(i - 64, -1), -1)
                      if host[j][1] >= mid and host[j][2] != window_name), None)
        if label is None:
            k = bisect.bisect_right(span_starts, mid) - 1
            label = spans[k][2] if k >= 0 and spans[k][1] >= mid else "python"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return busy / 1e9, kernels, {"device_ops": top(kernels), "idle_gaps": top(idle)}


def run(cell: str, seed: int, seconds: float, trace: bool, device=None,
        edit=None, control: bool = False, entry: Optional[Dict] = None) -> Dict:
    """Run one cell and return its result line (a dict).  ``device``
    defaults to the first card; ``edit(cfg, traffic)`` (tests) may shrink
    the configuration and the traffic; ``control`` also reads the
    control's numbers (``result["control"]``); ``entry`` (tests) gives the
    configuration and traffic of a cell that ``BENCHMARK.json`` does not
    list yet."""
    t_start = time.perf_counter()
    bench = benchmark_file()
    if entry is None:
        entry = next(w for w in bench["workloads"] if w["name"] == cell)
    workload = load_json("workloads", cell)
    cfg = load_json("configs", entry["config"])
    traffic = load_json("traffic", entry["traffic"])
    if edit is not None:
        edit(cfg, traffic)
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    kind = load_module("entries", traffic["entry"])
    ctx = Context(cell, workload, cfg, traffic, int(seed), device, Spans(trace, device), control)
    cuda = device.type == "cuda"

    state = kind.setup(ctx)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                      + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
    ctx.spans.times.clear()
    with torch.profiler.record_function("bench.window") if trace else contextlib.nullcontext():
        t0 = time.perf_counter()
        out = kind.window(ctx, state, seconds)
        if cuda:
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run_info = Run(ctx, out["records"], window_s, peak_bytes=window_peak)
    breakdown = None
    if trace:
        prof.__exit__(None, None, None)
        run_info.busy_s, run_info.kernels, breakdown = reduce_trace(prof)
        del prof
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    t_check = time.perf_counter()
    checks = kind.check(ctx, state, out)
    print(f"set-up {setup_s:.2f} s, window {window_s:.2f} s, check "
          f"{time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    correct = all(value <= limit for _, value, limit in checks) and bool(checks)
    # a number that is not finite (no alignment of the served tokens) prints
    # as a large one: the line stays JSON
    checks = [(name, value if math.isfinite(value) else 1e30, limit)
              for name, value, limit in checks]

    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if cell not in m.get("workloads", [cell]):
                continue
            value = load_module("metrics", m["name"]).read(run_info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=setup_s)
        for m in bench["end_to_end"]:
            if cell in m.get("workloads", [cell]) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": memory_peak}}
    if trace:
        result["device"]["busy_s"] = run_info.busy_s
        result["device"]["window_s"] = run_info.window_s
        result["breakdown"] = breakdown
    result["card"] = power_limit() if cuda else None
    if control:
        result["control"] = ctx.readings
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result

