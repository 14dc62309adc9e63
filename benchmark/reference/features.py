"""The plain log-mel frontend, in float64.

``librosa.feature.melspectrogram(wave, 16000, n_fft=512, hop_length=160,
n_mels=128)`` as the reference repository calls it (``tt/utils.py``):
centred frames (reflect padding of ``n_fft // 2``), the periodic Hann
window, the power spectrum, Slaney's mel scale and normalisation; then one
of the two logs (``eps``: ``log10`` with zeros floored to float64's eps,
training; ``masked``: the natural log with non-positive bins at 0,
recognition), ``left`` past and ``right`` future frames stacked with zeros
past the edges, every ``factor``-th row kept, at most ``max_frames`` rows,
and zero rows after them up to ``max_frames``.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

SR, N_FFT, HOP, N_MELS = 16000, 512, 160, 128


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    step = math.log(6.4) / 27.0
    return np.where(f >= min_hz, min_hz / f_sp + np.log(np.maximum(f, min_hz) / min_hz) / step,
                    f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    step = math.log(6.4) / 27.0
    min_mel = min_hz / f_sp
    return np.where(m >= min_mel, min_hz * np.exp(step * (m - min_mel)), f_sp * m)


def mel_matrix(n_mels: int = N_MELS) -> np.ndarray:
    """(1 + n_fft // 2, n_mels) Slaney-normalised triangles over 0..sr/2."""
    fft_hz = np.linspace(0.0, SR / 2.0, 1 + N_FFT // 2)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2.0), n_mels + 2))
    ramps = hz[:, None] - fft_hz[None, :]
    width = np.diff(hz)
    tri = np.maximum(0.0, np.minimum(-ramps[:-2] / width[:-1, None], ramps[2:] / width[1:, None]))
    return (tri * (2.0 / (hz[2:] - hz[:-2]))[:, None]).T


def logmel(wave: np.ndarray, variant: str, device, n_mels: int = N_MELS) -> torch.Tensor:
    """(frames, n_mels) float64 log-mel of one int16 wave."""
    x = torch.as_tensor(wave.astype(np.float64), device=device)
    x = torch.nn.functional.pad(x[None, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[0, 0]
    frames = x.unfold(0, N_FFT, HOP)
    n = torch.arange(N_FFT, device=device, dtype=torch.float64)
    window = 0.5 - 0.5 * torch.cos(2 * math.pi * n / N_FFT)
    spec = torch.fft.rfft(frames * window, dim=-1)
    mel = (spec.real ** 2 + spec.imag ** 2) @ torch.as_tensor(mel_matrix(n_mels), device=device)
    if variant == "eps":
        return torch.log10(torch.where(mel == 0, torch.full_like(mel, np.finfo(np.float64).eps),
                                       mel))
    return torch.where(mel > 0, torch.log(mel.clamp(min=1e-300)), torch.zeros_like(mel))


def features(waves: List[np.ndarray], variant: str, max_frames: int, left: int,
             right: int, factor: int, device, n_mels: int = N_MELS) -> torch.Tensor:
    """(B, max_frames, n_mels * (left + 1 + right)) float32 features of the
    waves, zero rows past each wave's frames."""
    rows = []
    for wave in waves:
        lm = logmel(wave, variant, device, n_mels)
        t = lm.shape[0]
        pieces = []
        for off in range(-left, right + 1):
            shifted = torch.zeros_like(lm)
            lo, hi = max(-off, 0), min(t - off, t)
            if hi > lo:
                shifted[lo:hi] = lm[lo + off:hi + off]
            pieces.append(shifted)
        feats = torch.cat(pieces, -1)[::factor][:max_frames]
        out = torch.zeros((max_frames, feats.shape[1]), dtype=torch.float64, device=device)
        out[:feats.shape[0]] = feats
        rows.append(out)
    return torch.stack(rows).float()


def frames(n_samples: int, max_frames: int, factor: int) -> int:
    """Feature rows of a wave of ``n_samples`` samples."""
    return min(-(-(1 + n_samples // HOP) // factor), max_frames)
