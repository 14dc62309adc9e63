"""Render a feature matrix (a log-mel spectrogram) as an image (port of the
repo-root ``tools/plot_features.py``).

    python -m transformer_transducer_tpu_torch.tools.plot_features utt.wav --out utt.png
    python -m transformer_transducer_tpu_torch.tools.plot_features feats.ark:12 --out utt.png
    python -m transformer_transducer_tpu_torch.tools.plot_features utt.wav --stack 3 --subsample 3

The reference's ``tensor_to_img`` (``tt/utils.py:332-336``) shows a feature
tensor transposed; here it is written to a PNG (matplotlib's headless Agg
backend, imported only to draw).  The input is a wav file (features through
``ops/features_np.py``, as the recognition apps compute them) or a kaldi
matrix (``path`` or ``path:offset``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from transformer_transducer_tpu_torch.data import kaldiio
from transformer_transducer_tpu_torch.data.wav import read_wave
from transformer_transducer_tpu_torch.ops import features_np as F


def load_features(path: str, feature_dim: int = 128, stack: int = 0,
                  subsample: int = 1) -> np.ndarray:
    """(T, D) float32 features from a wav file or a kaldi matrix path."""
    base = path.rsplit(":", 1)[0]
    if base.lower().endswith(".wav"):
        wave, rate = read_wave(base)
        feats = F.logmel_masked(wave, rate, feature_dim)
        if stack:
            feats = F.stack_frames(feats, stack, 0)
        if subsample > 1:
            feats = F.subsample(feats, subsample)
        return feats
    return kaldiio.read_mat(path)


def save_image(feats: np.ndarray, out: str, title: str = "") -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(max(4, feats.shape[0] / 50), 4))
    # transposed like the reference: time on x, the mel bin on y
    im = ax.imshow(feats.T, origin="lower", aspect="auto", interpolation="nearest")
    ax.set_xlabel("frame")
    ax.set_ylabel("feature bin")
    if title:
        ax.set_title(title)
    fig.colorbar(im, ax=ax, fraction=0.03)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="wav file or kaldi matrix (path[:offset])")
    ap.add_argument("--out", default=None, help="output PNG (default: <input>.png)")
    ap.add_argument("--feature-dim", type=int, default=128)
    ap.add_argument("--stack", type=int, default=0,
                    help="left history frames to stack (0 = the raw log-mel)")
    ap.add_argument("--subsample", type=int, default=1)
    args = ap.parse_args(argv)

    feats = load_features(args.path, args.feature_dim, args.stack, args.subsample)
    out = args.out or (os.path.splitext(args.path.rsplit(":", 1)[0])[0] + ".png")
    save_image(feats, out, title=os.path.basename(args.path))
    print(f"{feats.shape[0]}x{feats.shape[1]} features -> {out}")
    return out


if __name__ == "__main__":
    main()
