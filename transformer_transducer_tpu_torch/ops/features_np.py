"""CPU (numpy) log-mel frontend (port of ``ops/features_np.py``).

The reference extracts features with ``librosa.feature.melspectrogram(wave,
sr, n_fft=512, hop_length=160, n_mels=128)`` followed by one of two log
variants (``tt/utils.py:180-205``):

* ``logmel_masked`` — natural log, non-positive bins -> 0 (recognition apps);
* ``logmel_eps`` — floor zeros to float eps then ``log10`` (training).

The mel pipeline (hann STFT with centred reflect padding, power spectrum,
Slaney-normalised mel filterbank) is written from the published definitions.
Frame stacking and subsampling mirror ``tt/utils.py:120-150``.

With ``TTX_NATIVE_FEATURES=1`` an int16 wave (the dataset's input) takes
the C++ featurizer of ``runtime/native.py`` (``ttx_logmel``: the same
filterbank, float64 throughout, close to this pipeline run in float64,
where the numpy path's float32 FFT can move a mel bin that holds little of
a frame's energy by a few 1e-4 in its log); a float wave takes numpy
either way.
"""

from __future__ import annotations

import os

import numpy as np

from transformer_transducer_tpu_torch.runtime import native

SAMPLE_RATE = 16000
N_FFT = 512
HOP_LENGTH = 160
N_MELS = 128


def hann_window(n_fft: int = N_FFT) -> np.ndarray:
    """Periodic ("fftbins") Hann window, matching scipy/librosa's default."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)).astype(np.float64)


def hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asanyarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = freq >= min_log_hz
    return np.where(above, min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep, mels)


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = mels >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(sr: int = SAMPLE_RATE, n_fft: int = N_FFT,
                   n_mels: int = N_MELS) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank over 0..sr/2, shape
    ``(n_mels, 1 + n_fft // 2)``."""
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def frame_signal(wave: np.ndarray, n_fft: int = N_FFT, hop: int = HOP_LENGTH) -> np.ndarray:
    """Overlapping frames of ``wave``, centred by reflect padding."""
    wave = np.pad(np.asarray(wave, dtype=np.float32), n_fft // 2, mode="reflect")
    n_frames = 1 + (len(wave) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return wave[idx]


def power_spectrogram(wave: np.ndarray, n_fft: int = N_FFT, hop: int = HOP_LENGTH) -> np.ndarray:
    """float32 throughout, like librosa on the reference's float32 waves."""
    frames = frame_signal(wave, n_fft, hop)
    window = hann_window(n_fft).astype(np.float32)
    spec = np.fft.rfft(frames * window[None, :], axis=-1)
    return spec.real ** 2 + spec.imag ** 2


def melspectrogram(wave: np.ndarray, sr: int = SAMPLE_RATE, n_fft: int = N_FFT,
                   hop: int = HOP_LENGTH, n_mels: int = N_MELS) -> np.ndarray:
    """Power mel spectrogram, shape ``(frames, n_mels)``."""
    pspec = power_spectrogram(wave, n_fft, hop)
    return (pspec @ mel_filterbank(sr, n_fft, n_mels).T).astype(np.float32)


def _native_logmel(wave: np.ndarray, sr: int, n_mels: int, variant: str):
    """The C++ frame-parallel featurizer (``ttx_logmel``) when
    ``TTX_NATIVE_FEATURES=1`` and the wave is int16; None to take numpy
    (also where the C function refuses a wave of ``N_FFT // 2`` samples or
    fewer).

    Off by default, as in the JAX package: its gain is frame parallelism
    without the interpreter lock inside the loader's threads, which needs
    cores to spare; one call alone is slower than numpy's SIMD FFT and
    BLAS (``PERF.md`` §6), so enable it only where cores outnumber
    the loader's threads.  A failed build raises
    (``runtime/native.py``)."""
    if os.environ.get("TTX_NATIVE_FEATURES") != "1":
        return None
    if not isinstance(wave, np.ndarray) or wave.dtype != np.int16:
        return None
    lib = native.library_or_none()
    if lib is None:
        return None
    return lib.logmel(wave, mel_filterbank(sr, N_FFT, n_mels), N_FFT, HOP_LENGTH, variant)


def logmel_masked(wave: np.ndarray, sr: int = SAMPLE_RATE, n_mels: int = N_MELS) -> np.ndarray:
    """Natural-log mel with non-positive bins set to 0 (reference
    ``get_feature``, ``tt/utils.py:180-191``)."""
    out = _native_logmel(wave, sr, n_mels, "masked")
    if out is not None:
        return out
    mel = melspectrogram(wave.astype(np.float32), sr, n_mels=n_mels)
    out = np.zeros_like(mel)
    positive = mel > 0
    out[positive] = np.log(mel[positive])
    return out


def logmel_eps(wave: np.ndarray, sr: int = SAMPLE_RATE, n_mels: int = N_MELS) -> np.ndarray:
    """log10 mel with zeros floored to float eps (reference ``get_feature2``,
    ``tt/utils.py:194-205``)."""
    out = _native_logmel(wave, sr, n_mels, "eps")
    if out is not None:
        return out
    mel = melspectrogram(wave.astype(np.float32), sr, n_mels=n_mels)
    mel = np.where(mel == 0, np.finfo(np.float64).eps, mel)
    return np.log10(mel).astype(np.float32)


def stack_frames(features: np.ndarray, left: int = 3, right: int = 0) -> np.ndarray:
    """Concatenate each frame with ``left`` past and ``right`` future frames.

    Layout is chronological — ``[x[t-left], ..., x[t-1], x[t], x[t+1], ...]``
    with zeros past the sequence edges (``tt/utils.py:120-142``), including
    sequences shorter than the stack width.
    """
    t, _ = features.shape
    pieces = []
    for offset in range(-left, right + 1):
        shifted = np.zeros_like(features)
        lo, hi = max(-offset, 0), min(t - offset, t)
        if hi > lo:
            shifted[lo:hi] = features[lo + offset:hi + offset]
        pieces.append(shifted)
    return np.concatenate(pieces, axis=1).astype(np.float32)


def subsample(features: np.ndarray, factor: int = 3) -> np.ndarray:
    """Keep every ``factor``-th frame (``tt/utils.py:145-150``)."""
    return features[::factor]


def extract(wave: np.ndarray, sr: int = SAMPLE_RATE, n_mels: int = N_MELS,
            left: int = 3, right: int = 0, factor: int = 3,
            log_variant: str = "eps") -> np.ndarray:
    """wav -> log-mel -> stack -> subsample; ``log_variant`` 'eps' (training
    path) or 'masked' (recognition apps)."""
    logmel = logmel_eps(wave, sr, n_mels) if log_variant == "eps" else logmel_masked(wave, sr, n_mels)
    return subsample(stack_frames(logmel, left, right), factor)
