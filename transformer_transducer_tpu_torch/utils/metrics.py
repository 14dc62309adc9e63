"""Edit-distance metrics (CER), numpy only (port of ``utils/metrics.py``).

Same contract as the reference's ``computer_cer`` (``tt/utils.py:46-50``).
The JAX package's ctypes fast path waits for a port of ``runtime/native.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two sequences (of ints or strings), one numpy
    row per symbol of ``a``."""
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    b_arr = np.asarray(list(b), dtype=object) if not isinstance(b, np.ndarray) else b
    prev = np.arange(len(b) + 1, dtype=np.int64)
    steps = np.arange(len(b) + 1)
    for i, sym in enumerate(a, start=1):
        sub = prev[:-1] + (b_arr != sym)
        cur = np.empty_like(prev)
        cur[0] = i
        cand = np.minimum(prev[1:] + 1, sub)
        # insertion from the left neighbour: cur[j] = min_k<=j (cand[k] + j - k)
        shifted = np.minimum.accumulate(np.concatenate(([cur[0]], cand)) - steps)
        cur[1:] = np.minimum(shifted[1:] + steps[1:], cand)
        prev = cur
    return int(prev[-1])


def batch_cer(preds: Sequence[Sequence], labels: Sequence[Sequence]) -> Tuple[int, int]:
    """``(total edit distance, total label length)`` for a batch."""
    dist = sum(levenshtein(label, pred) for pred, label in zip(preds, labels))
    total = sum(len(label) for label in labels)
    return dist, total
