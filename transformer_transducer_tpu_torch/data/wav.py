"""WAV I/O via the stdlib (port of ``data/wav.py``)."""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_wave(path: str) -> Tuple[np.ndarray, int]:
    """Returns (int16 samples (mono), sample_rate)."""
    with wave.open(path, "rb") as wf:
        n = wf.getnframes()
        rate = wf.getframerate()
        channels = wf.getnchannels()
        data = np.frombuffer(wf.readframes(n), dtype=np.int16)
    if channels > 1:
        data = data.reshape(-1, channels)[:, 0]
    return data, rate


def write_wave(path: str, samples: np.ndarray, rate: int = 16000) -> None:
    samples = np.asarray(samples, dtype=np.int16)
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes(samples.tobytes())
