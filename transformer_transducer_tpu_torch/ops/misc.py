"""Small training and visualisation utilities from the reference's toolbox
(port of ``ops/misc.py``)."""

from __future__ import annotations

import numpy as np
import torch


def label_smoothing(inputs: torch.Tensor, epsilon: float = 0.1) -> torch.Tensor:
    """Smooth a one-hot or probability tensor over its last axis (reference
    ``tt/utils.py:292-294``)."""
    k = inputs.shape[-1]
    return (1.0 - epsilon) * inputs + epsilon / k


def save_spectrogram_image(spectrogram, path: str) -> None:
    """Render a (T, F) feature matrix to an image file (the headless twin of
    the reference's ``tensor_to_img`` plot window, ``tt/utils.py:332-336``).
    Imports matplotlib only when called."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    if isinstance(spectrogram, torch.Tensor):
        spectrogram = spectrogram.detach().cpu().numpy()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(np.asarray(spectrogram).T, origin="lower", aspect="auto")
    ax.set_xlabel("frames")
    ax.set_ylabel("bins")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
