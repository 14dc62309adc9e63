"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
argument they take ``cuda`` and raise when no card is present, so nothing
quietly falls back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); otherwise as given.

    On a CUDA device the float32 matmul and cuDNN paths are pinned to full
    float32 (no TF32), matching the JAX package's default ``compute_dtype``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
