"""Long-Term Spectral Divergence (LTSD) voice-activity detection (port of
``ops/vad.py``; numpy, host side).

The reference ships a standalone, unwired LTSD VAD (``preprocess/vad.py:
4-165``): Hann-windowed half-overlapping frames; the LTSE, each bin's
maximum over the +-``order`` neighbouring frames; the LTSD,
10 log10(mean(LTSE^2 / noise^2)); a decision threshold that interpolates
with the noise energy between (e0, thre0) and (e1, thre1); the noise
spectrum adapted every ``noise_update_every`` noise frames with smoothing
``ratio``; and the detected speech spans extracted.  The frames are computed
in one pass (the reference recomputes FFTs per query with a memo).

    vad = LtsdVad(LtsdConfig())
    decisions, spans = vad.detect(int16_wave)    # spans: [start, end) samples
    speech = vad.extract_speech(int16_wave)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class LtsdConfig:
    win_time_ms: float = 32.0
    order: int = 5
    e0: float = 40.0
    e1: float = 80.0
    thre0: float = 36.0
    thre1: float = 10.0
    ratio: float = 0.95          # noise-spectrum smoothing
    sample_rate: int = 16000
    noise_update_every: int = 20


class LtsdVad:
    def __init__(self, cfg: Optional[LtsdConfig] = None):
        self.cfg = cfg or LtsdConfig()
        self.winsize = int(self.cfg.win_time_ms / 1000 * self.cfg.sample_rate)
        self.shift = self.winsize // 2
        self.window = np.hanning(self.winsize)

    def _amplitudes(self, signal: np.ndarray) -> np.ndarray:
        """(frames, bins) magnitude spectra of half-overlapping frames."""
        n = (len(signal) - self.winsize) // self.shift + 1
        if n <= 0:
            return np.zeros((0, self.winsize // 2 + 1))
        idx = np.arange(self.winsize)[None, :] + self.shift * np.arange(n)[:, None]
        frames = signal[idx] * self.window[None, :]
        return np.abs(np.fft.rfft(frames, axis=-1))

    def _noise_spectrum(self, noise: np.ndarray) -> np.ndarray:
        n = max(int(len(noise) // self.shift - 1), 1)
        amps = self._amplitudes(noise.astype(np.float64))
        return amps[:n].mean(axis=0) if len(amps) else np.ones(self.winsize // 2 + 1)

    def detect(self, signal: np.ndarray,
               noise: Optional[np.ndarray] = None,
               noise_samples: int = 1600) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
        """Returns (per-frame speech decision, merged [start, end) sample spans)."""
        cfg = self.cfg
        sig = np.asarray(signal, dtype=np.float64)
        if noise is None:
            noise = sig[-noise_samples:]
            if not noise.any():
                noise = np.random.default_rng(0).integers(1, 10, size=len(noise))
        avg_noise = self._noise_spectrum(np.asarray(noise, dtype=np.float64))

        amps = self._amplitudes(sig)
        n_frames = amps.shape[0]
        order = cfg.order
        decisions = np.zeros(n_frames, dtype=bool)
        noise_count = 0

        # LTSE via a sliding max over ±order frames (vectorized per frame set)
        for i in range(n_frames):
            if i < order or i + order >= n_frames:
                continue
            ltse = amps[i - order:i + order + 1].max(axis=0)
            ltsd = 10.0 * np.log10(np.mean(ltse ** 2 / np.maximum(avg_noise, 1e-12) ** 2))
            energy = 10.0 * np.log10(np.mean(avg_noise) ** 2 + 1e-300)
            if energy < cfg.e0:
                thre = cfg.thre0
            elif energy > cfg.e1:
                thre = cfg.thre1
            else:
                slope = (cfg.thre0 - cfg.thre1) / (cfg.e0 - cfg.e1)
                thre = slope * energy + cfg.thre0 - slope * cfg.e0
            if ltsd > thre:
                decisions[i] = True
            else:
                noise_count += 1
                if noise_count % cfg.noise_update_every == 0:
                    neighborhood = amps[max(0, i - order):i + order + 1].mean(axis=0)
                    avg_noise = avg_noise * cfg.ratio + neighborhood * (1 - cfg.ratio)

        spans: List[Tuple[int, int]] = []
        for i in np.flatnonzero(decisions):
            start = i * self.shift
            end = start + self.winsize
            if spans and start <= spans[-1][1]:
                spans[-1] = (spans[-1][0], end)
            else:
                spans.append((start, end))
        return decisions, spans

    def extract_speech(self, signal: np.ndarray,
                       noise: Optional[np.ndarray] = None) -> np.ndarray:
        """Concatenate the detected speech spans (the reference ``vad()``
        return contract, ``preprocess/vad.py:113-155``)."""
        dtype = signal.dtype
        _, spans = self.detect(signal, noise)
        if not spans:
            return np.zeros(0, dtype=dtype)
        return np.concatenate([signal[s:e] for s, e in spans]).astype(dtype)
