"""Run one cell of the benchmark of ``transformer_transducer_tpu_torch`` on
the card and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the program (its kernels build once into ``build/`` of this
checkout), makes the weights and the traffic from ``--seed`` and warms up;
the window then runs the cell's work closed-loop for ``--seconds``; after
it, the plain reference judges what the window's path produced.  With
``--trace 1`` the window runs under ``torch.profiler`` and the line holds
the per-layer metrics, else the end-to-end ones.  Without a card the run
fails: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _cache_dirs() -> None:
    """Every compiler cache inside the checkout, at fixed paths."""
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness

    cell = next((w for w in harness.benchmark_file()["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 4
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
