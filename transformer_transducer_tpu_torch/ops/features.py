"""The log-mel frontend on the card (port of ``ops/features.py``).

The same function as :mod:`ops.features_np` (the host pipeline), on a
device tensor: framing is a strided view of the batch (``unfold``, a
static index), then the Hann window, ``torch.fft.rfft``, the power
spectrum and the mel projection as one ``torch.matmul``.  The JAX package
runs the FFT with XLA's own rfft and the projection as a plain product, no
Pallas kernel, so no hand-written kernel stands behind this module.

:func:`extract_batch_padded` featurizes the raw-wave batches of
``data.on_device_features`` (``data/dataset.py``) inside the train step and
the evaluation: the host ships padded waves and true sample counts, and the
card returns the stacked, subsampled features and their lengths.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from transformer_transducer_tpu_torch.ops import features_np as fnp

SAMPLE_RATE = fnp.SAMPLE_RATE
N_FFT = fnp.N_FFT
HOP_LENGTH = fnp.HOP_LENGTH
N_MELS = fnp.N_MELS

EPS = float(np.float32(np.finfo(np.float64).eps))   # the eps variant's floor
TINY = float(np.finfo(np.float32).tiny)


@functools.lru_cache(maxsize=None)
def _mel_matrix_np(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    return fnp.mel_filterbank(sr, n_fft, n_mels).T.copy()   # (bins, n_mels)


@functools.lru_cache(maxsize=None)
def _constants(sr: int, n_fft: int, n_mels: int, device: torch.device):
    """(Hann window, mel matrix) as float32 tensors on ``device``, made once
    a device."""
    window = torch.from_numpy(fnp.hann_window(n_fft).astype(np.float32))
    mel = torch.from_numpy(_mel_matrix_np(sr, n_fft, n_mels))
    return window.to(device), mel.to(device)


def _device_key(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def melspectrogram(wave: torch.Tensor, sr: int = SAMPLE_RATE, n_fft: int = N_FFT,
                   hop: int = HOP_LENGTH, n_mels: int = N_MELS) -> torch.Tensor:
    """Power mel spectrogram of ``(..., samples)`` waves, shape ``(...,
    frames, n_mels)``, framed as given: the JAX function's ``center=False``,
    for waves the host already edge-reflected (the on-device-features
    layout)."""
    window, mel = _constants(sr, n_fft, n_mels, _device_key(wave.device))
    frames = wave.to(torch.float32).unfold(-1, n_fft, hop) * window
    spec = torch.fft.rfft(frames, dim=-1)
    pspec = spec.real ** 2 + spec.imag ** 2
    return torch.matmul(pspec, mel)


def log_eps(mel: torch.Tensor) -> torch.Tensor:
    """log10 with zeros floored to float eps (the training variant)."""
    return torch.log10(torch.where(mel == 0, torch.full_like(mel, EPS), mel))


def log_masked(mel: torch.Tensor) -> torch.Tensor:
    """Natural log, non-positive bins -> 0 (the recognition variant)."""
    return torch.where(mel > 0, torch.log(torch.clamp(mel, min=TINY)),
                       torch.zeros_like(mel))


def stack_frames(features: torch.Tensor, left: int = 3, right: int = 0) -> torch.Tensor:
    """Chronological frame stacking over the frame axis (-2) with zero
    edges: piece ``offset`` of row ``i`` is ``features[..., i + offset, :]``
    when in range, else zero (the host stack's rule)."""
    t = features.shape[-2]
    pieces = []
    for offset in range(-left, right + 1):
        shifted = torch.zeros_like(features)
        lo, hi = max(-offset, 0), min(t - offset, t)   # valid destination rows
        if hi > lo:
            shifted[..., lo:hi, :] = features[..., lo + offset:hi + offset, :]
        pieces.append(shifted)
    return torch.cat(pieces, dim=-1)


def subsample(features: torch.Tensor, factor: int = 3) -> torch.Tensor:
    return features[..., ::factor, :]


# ---------------------------------------------------------------------------
# the raw-wave batches of data.on_device_features

def raw_frame_count(n_samples, hop: int = HOP_LENGTH):
    """Frames of the centred STFT over ``n_samples`` true samples (ints or
    tensors): the host pipeline's count."""
    return 1 + n_samples // hop


def padded_wave_samples(max_frames: int, factor: int = 3,
                        hop: int = HOP_LENGTH, n_fft: int = N_FFT) -> Tuple[int, int]:
    """(true-sample capacity, padded length) of a raw wave for a
    ``max_frames``-row feature budget: the host clips the wave to ``cap``
    samples, reflects ``n_fft // 2`` at each edge and zero-pads to
    ``total``."""
    raw_frames = (max_frames - 1) * factor + 1
    cap = (raw_frames - 1) * hop
    return cap, cap + n_fft


def _frame_counts(n_samples: torch.Tensor, max_frames: int, factor: int):
    """(log-mel frames, feature lengths) of waves of ``n_samples`` samples."""
    raw_frames = (max_frames - 1) * factor + 1
    frames_true = torch.clamp(raw_frame_count(n_samples), max=raw_frames)
    return frames_true, torch.clamp((frames_true + factor - 1) // factor, max=max_frames)


def feature_lengths(n_samples, max_frames: int, factor: int = 3) -> torch.Tensor:
    """The ``(B,)`` feature lengths :func:`extract_batch_padded` gives
    waves of ``n_samples`` samples, without the features."""
    return _frame_counts(torch.as_tensor(n_samples).to(torch.long), max_frames, factor)[1]


def extract_batch_padded(waves: torch.Tensor, n_samples: torch.Tensor,
                         max_frames: int, sr: int = SAMPLE_RATE,
                         n_mels: int = N_MELS, left: int = 3, right: int = 0,
                         factor: int = 3, log_variant: str = "eps"):
    """Featurize a host-padded ``(B, total)`` wave batch (the layout of
    :func:`padded_wave_samples`: ``n_fft // 2`` reflected samples around at
    most ``cap`` true samples, then zeros) on its device: ``(B, max_frames,
    n_mels * (left + 1 + right))`` float32 features and ``(B,)`` feature
    lengths.  Log-mel rows past the true frame count are zeroed before
    stacking (the host stack's zero edge) and feature rows past ``t_len``
    after subsampling (the host's pad rows)."""
    b, total = waves.shape
    raw_frames = (max_frames - 1) * factor + 1
    expect = (raw_frames - 1) * HOP_LENGTH + N_FFT
    if total != expect:
        raise ValueError(f"padded wave length {total} != {expect} expected for "
                         f"max_frames={max_frames} (see padded_wave_samples)")
    n_samples = torch.as_tensor(n_samples, device=waves.device).to(torch.long)
    frames_true, t_len = _frame_counts(n_samples, max_frames, factor)
    mel = melspectrogram(waves, sr, n_mels=n_mels)
    logmel = log_eps(mel) if log_variant == "eps" else log_masked(mel)
    rows = torch.arange(raw_frames, device=waves.device)
    zero = torch.zeros((), device=waves.device)
    logmel = torch.where((rows[None, :] < frames_true[:, None])[..., None], logmel, zero)
    feats = subsample(stack_frames(logmel, left, right), factor)
    keep = torch.arange(max_frames, device=waves.device)[None, :] < t_len[:, None]
    return torch.where(keep[..., None], feats, zero), t_len
