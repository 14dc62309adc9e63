"""Time the banded rel-position attention backward (``ttx_banded_attention_bwd``)
alone, as ``chip_smoke.py`` times it: 20 calls of the wrapper in one CUDA
graph, the median of 10 replays, per call.  Each checkout given runs in its
own process (the packages share a name), builds its own kernels into its own
``build/`` and is timed at every shape; the checkouts run in the order given,
so ``--roots old new new old`` compares two versions on one card in one run.

    python3 transformer_transducer_tpu_torch/tools/time_banded_bwd.py \\
        --roots build/parent . . build/parent \\
        --shapes 4,410,8,64 4,410,8,32 4,48,2,32 --band 10 2

A shape is B,T,H,Dh (inputs fp32, drawn from a seed).  Prints one line a
checkout and shape, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def time_one(root: str, shapes, band) -> None:
    """Time the backward of the package under ``root`` at each shape."""
    sys.path.insert(0, REPO)
    import torch
    from chip_smoke import graph_ms         # this checkout's timer for every root
    sys.path.insert(0, os.path.abspath(root))
    from transformer_transducer_tpu_torch.ops.cuda import common
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention_backward)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, t, h, dh in shapes:
        mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")
        args = (mk(b, t, h, dh), mk(b, t, h, dh), mk(b, t, h, dh), mk(t, h, dh),
                mk(h, dh), mk(t, h))
        out, lse, _ = common.launch_forward("ttx_banded_attention_fwd", args, band,
                                            with_lse=True)
        gout = mk(b, t, h, dh)
        ms = graph_ms(lambda: banded_attention_backward(*args, out, lse, gout, *band))
        print(json.dumps({"root": root, "B": b, "T": t, "H": h, "Dh": dh,
                          "band": list(band), "ms": ms}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."],
                    help="checkouts whose port package is timed, in this order")
    ap.add_argument("--shapes", nargs="+", default=["4,410,8,64"], help="B,T,H,Dh")
    ap.add_argument("--band", nargs=2, type=int, default=[10, 2], metavar=("LEFT", "RIGHT"))
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    shapes = [tuple(int(x) for x in s.split(",")) for s in a.shapes]
    if a.one:
        time_one(a.one, shapes, tuple(a.band))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    for root in a.roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", root, "--shapes",
               *a.shapes, "--band", *map(str, a.band)]
        if subprocess.run(cmd).returncode != 0:
            return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
