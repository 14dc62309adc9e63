"""Plot training curves from an experiment's ``metrics.jsonl`` (port of the
repo-root ``tools/plot_training.py``).

    python -m transformer_transducer_tpu_torch.tools.plot_training EXP_DIR [--out curves.png]
    python -m transformer_transducer_tpu_torch.tools.plot_training EXP_DIR --print

The reference records its 28-epoch loss and CER curves in hard-coded arrays
and a matplotlib plot (``assets/information.py:10-30``); here the curves
are the JSON lines the trainer writes.  Prints one summary line a series;
matplotlib is imported only to draw (not with ``--print``).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict


def load_metrics(exp_dir: str) -> dict:
    """``{tag: [(step, value), ...]}`` in file order."""
    series = defaultdict(list)
    with open(os.path.join(exp_dir, "metrics.jsonl")) as fh:
        for line in fh:
            if line.strip():
                rec = json.loads(line)
                series[rec["tag"]].append((rec["step"], rec["value"]))
    return series


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("exp_dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--print", dest="print_only", action="store_true")
    args = ap.parse_args(argv)

    series = load_metrics(args.exp_dir)
    if not series:
        print("no metrics recorded yet (metrics.jsonl is empty)")
        return None
    for tag, pts in sorted(series.items()):
        vals = [v for _, v in pts]
        print(f"{tag}: {len(pts)} points, first {vals[0]:.4f}, "
              f"last {vals[-1]:.4f}, min {min(vals):.4f}")
    if args.print_only:
        return None

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(series), figsize=(5 * len(series), 4))
    if len(series) == 1:
        axes = [axes]
    for ax, (tag, pts) in zip(axes, sorted(series.items())):
        xs, ys = zip(*pts)
        ax.plot(xs, ys)
        ax.set_title(tag)
        ax.set_xlabel("step")
        ax.grid(True, alpha=0.3)
    out = args.out or os.path.join(args.exp_dir, "curves.png")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
