"""Waveform augmentation (CPU-side, numpy) — the data-pipeline chain (port
of ``ops/augment.py``, the same numpy code: for the same generator the
port's waves equal the JAX package's to the bit).

Parity surface: the reference applies a probability-gated chain to raw int16
samples (reference: ``augment/audio_augment.py:15-23``): gaussian white noise
(p=0.4), dB-FS volume gain (p=0.4), linear-interp speed 0.9-1.1x (p=0.4),
±5% circular time shift (p=0.1).  Pitch shift and natural-noise overlay exist
in the reference but are not wired into its chain; we expose them too.

All functions take an explicit ``numpy.random.Generator`` — no global RNG.
"""

from __future__ import annotations

import numpy as np


def gaussian_white_noise(rng: np.random.Generator, samples: np.ndarray,
                         min_db: int = 10, max_db: int = 200) -> np.ndarray:
    """Additive N(0, db) noise (reference ``noise_augment.py:57-77``)."""
    dtype = samples.dtype
    db = rng.integers(min_db, max_db)
    noise = db * rng.standard_normal(len(samples))
    return (samples + noise).astype(dtype)


def uniform_white_noise(rng: np.random.Generator, samples: np.ndarray,
                        min_db: int = 10, max_db: int = 200) -> np.ndarray:
    dtype = samples.dtype
    db = rng.integers(min_db, max_db)
    noise = rng.uniform(-db, db, size=len(samples))
    return (samples + noise).astype(dtype)


def natural_noise(rng: np.random.Generator, samples: np.ndarray,
                  noise_wave: np.ndarray, max_db: float = 0.5) -> np.ndarray:
    """Overlay a random slice of a natural-noise recording
    (reference ``noise_augment.py:15-40``)."""
    dtype = samples.dtype
    db = rng.uniform(0.1, max_db)
    tiled = noise_wave
    while len(tiled) <= len(samples):
        tiled = np.concatenate([tiled, tiled])
    start = rng.integers(0, len(tiled) - len(samples))
    return (samples + db * tiled[start:start + len(samples)]).astype(dtype)


def volume_gain(rng: np.random.Generator, samples: np.ndarray,
                min_gain_dbfs: float = -15.0, max_gain_dbfs: float = 15.0) -> np.ndarray:
    """Random dB-FS gain (reference ``volume_augment.py:13-27``)."""
    dtype = samples.dtype
    gain = rng.uniform(min_gain_dbfs, max_gain_dbfs)
    return (samples * (10.0 ** (gain / 20.0))).astype(dtype)


def speed_perturb(rng: np.random.Generator, samples: np.ndarray,
                  min_rate: float = 0.9, max_rate: float = 1.1) -> np.ndarray:
    """Linear-interpolation resampling (reference ``speed_augment.py:14-31``)."""
    dtype = samples.dtype
    rate = rng.uniform(min_rate, max_rate)
    old_n = len(samples)
    new_n = int(old_n / rate)
    old_idx = np.arange(old_n)
    new_idx = np.linspace(0, old_n - 1, new_n)
    return np.interp(new_idx, old_idx, samples.astype(np.float64)).astype(dtype)


def speed_perturb_stft(rng: np.random.Generator, samples: np.ndarray,
                       min_rate: float = 0.9, max_rate: float = 1.1,
                       n_fft: int = 512, hop: int = 128) -> np.ndarray:
    """Pitch-preserving phase-vocoder time stretch — the analog of the
    reference's ``speed_librosa`` (``speed_augment.py:34-49``,
    ``librosa.effects.time_stretch``), implemented directly on the STFT.
    Unlike :func:`speed_perturb` (plain resampling) the pitch is unchanged.
    """
    dtype = samples.dtype
    rate = rng.uniform(min_rate, max_rate)
    x = samples.astype(np.float64)
    win = np.hanning(n_fft)
    n_frames = max(1, 1 + (len(x) - n_fft) // hop)
    frames = np.lib.stride_tricks.as_strided(
        x, (n_frames, n_fft), (x.strides[0] * hop, x.strides[0])).copy()
    stft = np.fft.rfft(frames * win, axis=1)               # (F, n_fft/2+1)

    # phase vocoder: sample frame positions at `rate`, interpolate magnitude,
    # accumulate per-bin phase advance corrected by the expected hop phase
    steps = np.arange(0, n_frames - 1, rate)
    omega = 2 * np.pi * hop * np.arange(stft.shape[1]) / n_fft
    mag0, mag1 = np.abs(stft[steps.astype(int)]), \
        np.abs(stft[np.minimum(steps.astype(int) + 1, n_frames - 1)])
    frac = (steps - steps.astype(int))[:, None]
    mags = (1 - frac) * mag0 + frac * mag1
    dphase = np.angle(stft[np.minimum(steps.astype(int) + 1, n_frames - 1)]) \
        - np.angle(stft[steps.astype(int)]) - omega[None]
    dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
    phases = np.cumsum(np.concatenate(
        [np.angle(stft[:1]), omega[None] + dphase[:-1]], axis=0), axis=0)
    out_frames = np.fft.irfft(mags * np.exp(1j * phases), n=n_fft, axis=1)

    # windowed overlap-add with COLA normalization
    out_len = n_fft + hop * (len(steps) - 1)
    out = np.zeros(out_len)
    norm = np.zeros(out_len)
    for i in range(len(steps)):                       # bounded (~len/hop) loop
        out[i * hop:i * hop + n_fft] += out_frames[i] * win
        norm[i * hop:i * hop + n_fft] += win ** 2
    out /= np.maximum(norm, 1e-8)
    return out.astype(dtype)


def speed_perturb_chunked(rng: np.random.Generator, samples: np.ndarray,
                          min_rate: float = 1.05, max_rate: float = 1.3,
                          chunk: int = 2048, crossfade: int = 128) -> np.ndarray:
    """Chunk-dropping speedup with crossfades — a WORKING analog of the
    reference's ``speed_pydub`` (``speed_augment.py:53-69``; that one
    ignores its rate argument and feeds pydub a raw ndarray, so it cannot
    run).  Only speeds up (rate > 1), like ``pydub.effects.speedup``."""
    dtype = samples.dtype
    rate = rng.uniform(min_rate, max_rate)
    x = samples.astype(np.float64)
    keep = int(chunk / rate)
    pieces = []
    for start in range(0, len(x), chunk):
        seg = x[start:start + chunk][:keep]
        if pieces and len(seg) > crossfade and len(pieces[-1]) > crossfade:
            ramp = np.linspace(0.0, 1.0, crossfade)
            pieces[-1][-crossfade:] = (pieces[-1][-crossfade:] * (1 - ramp)
                                       + seg[:crossfade] * ramp)
            seg = seg[crossfade:]
        pieces.append(seg.copy())
    return np.concatenate(pieces).astype(dtype)


def time_shift(rng: np.random.Generator, samples: np.ndarray,
               max_ratio: float = 0.05) -> np.ndarray:
    """Circular roll by up to ±max_ratio of the length
    (reference ``time_shift_augment.py:41-55``)."""
    frac = rng.uniform(-max_ratio, max_ratio)
    return np.roll(samples, int(len(samples) * frac))


def time_shift_fixed(samples: np.ndarray, ratio: float = 0.05) -> np.ndarray:
    """Fixed-amount circular LEFT roll — the reference's ``time_shift_baidu``
    (``time_shift_augment.py:12-39``; its random amount is commented out, so
    it always advances by ``int(len * ratio)``)."""
    return np.roll(samples, -int(len(samples) * ratio))


def pitch_shift_fft(rng: np.random.Generator, samples: np.ndarray,
                    sr: int = 16000, max_semitones: float = 2.0) -> np.ndarray:
    """Simple FFT-bin-shift pitch perturbation (reference exposes librosa/cv
    pitch shift, unwired: ``pitch_augment.py:14-40``)."""
    dtype = samples.dtype
    steps = rng.uniform(-max_semitones, max_semitones)
    factor = 2.0 ** (steps / 12.0)
    spec = np.fft.rfft(samples.astype(np.float64))
    n = len(spec)
    idx = (np.arange(n) / factor).astype(np.int64)
    shifted = np.where(idx < n, spec[np.minimum(idx, n - 1)], 0)
    return np.fft.irfft(shifted, n=len(samples)).astype(dtype)


def audio_augment(rng: np.random.Generator, samples: np.ndarray) -> np.ndarray:
    """The reference's probability-gated chain (``audio_augment.py:15-23``)."""
    if rng.random() < 0.4:
        samples = gaussian_white_noise(rng, samples, min_db=1, max_db=10)
    if rng.random() < 0.4:
        samples = volume_gain(rng, samples)
    if rng.random() < 0.4:
        samples = speed_perturb(rng, samples)
    if rng.random() < 0.1:
        samples = time_shift(rng, samples)
    return samples
