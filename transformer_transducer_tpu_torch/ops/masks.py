"""Attention masks, True == masked position (port of ``ops/masks.py``).

* ``look_ahead_mask`` — strict upper-triangular causal mask for the label
  encoder;
* ``context_mask`` — banded streaming mask: position *i* may attend to
  ``[i - left, i + right]`` only (reference ``tt/utils.py:233-251``);
* ``padding_mask`` — length-based key padding (the espnet family's pad
  mask), and ``combine_masks``, their broadcast OR.
"""

from __future__ import annotations

from typing import Optional

import torch


def look_ahead_mask(seq_len: int, device=None) -> torch.Tensor:
    """(U, U) bool; True above the diagonal (no peeking at future labels)."""
    return torch.ones((seq_len, seq_len), dtype=torch.bool, device=device).triu(1)


def context_mask(seq_len: int, left: int = 10, right: int = 2,
                 device=None) -> torch.Tensor:
    """(T, T) bool band mask: True outside ``[i - left, i + right]``.

    ``left < 0`` or ``right < 0`` means unlimited on that side.
    """
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    mask = torch.zeros((seq_len, seq_len), dtype=torch.bool, device=device)
    if right >= 0:
        mask = mask | (j - i > right)
    if left >= 0:
        mask = mask | (i - j > left)
    return mask


def padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, T) bool; True at padded positions (``j >= lengths[b]``)."""
    lengths = torch.as_tensor(lengths)
    return torch.arange(max_len, device=lengths.device)[None, :] >= lengths[:, None]


def combine_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Broadcast OR of masks; ``None`` entries are skipped (all ``None``:
    ``None``)."""
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else (out | m)
    return out
