"""Edit-distance metrics (CER) with the native C++ path (port of
``utils/metrics.py``).

Same contract as the reference's ``computer_cer`` (``tt/utils.py:46-50``).
Integer-id sequences go through ``runtime/native.py`` (``ttx_levenshtein``,
and ``ttx_batch_levenshtein`` for a whole batch in one call); strings, and
hosts without a C++ compiler, take the numpy functions, which are also the
plain versions the tests hold the native path to.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from transformer_transducer_tpu_torch.runtime import native


def levenshtein_numpy(a: Sequence, b: Sequence) -> int:
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


def batch_cer_numpy(preds: Sequence[Sequence], labels: Sequence[Sequence]) -> Tuple[int, int]:
    """``(total edit distance, total label length)``, pair by pair in numpy."""
    dist = sum(levenshtein_numpy(label, pred) for pred, label in zip(preds, labels))
    total = sum(len(label) for label in labels)
    return dist, total


def _as_int_ids(seq) -> Optional[np.ndarray]:
    """``seq`` as an int32 array if it is a sequence of integers (an empty
    one included), else None."""
    arr = np.asarray(seq)
    if arr.ndim != 1:
        return None
    if arr.size == 0:
        return np.zeros(0, np.int32)
    if arr.dtype.kind in "iu":
        return arr.astype(np.int32)
    return None


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two sequences (of ints or strings)."""
    ai, bi = _as_int_ids(a), _as_int_ids(b)
    if ai is not None and bi is not None:
        lib = native.library_or_none()
        if lib is not None:
            return lib.levenshtein(ai, bi)
    return levenshtein_numpy(a, b)


def batch_cer(preds: Sequence[Sequence], labels: Sequence[Sequence]) -> Tuple[int, int]:
    """``(total edit distance, total label length)`` for a batch: integer-id
    batches in one native call, others pair by pair in numpy."""
    if len(preds) != len(labels):
        raise ValueError(f"{len(preds)} predictions against {len(labels)} labels")
    ids = [_as_int_ids(s) for s in (*preds, *labels)]
    if preds and all(x is not None for x in ids):
        lib = native.library_or_none()
        if lib is not None:
            return lib.batch_levenshtein(ids[:len(preds)], ids[len(preds):])
    return batch_cer_numpy(preds, labels)
