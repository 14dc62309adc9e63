"""Attention masks, True == masked position (port of ``ops/masks.py``).

* ``look_ahead_mask`` — strict upper-triangular causal mask for the label
  encoder;
* ``context_mask`` — banded streaming mask: position *i* may attend to
  ``[i - left, i + right]`` only (reference ``tt/utils.py:233-251``).
"""

from __future__ import annotations

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
