"""The benchmark's one traffic generator.

A traffic file (``benchmark/traffic/<name>.json``) holds parameters only;
this module turns them and ``--seed`` into batches on the host.

Utterance durations follow a log-normal with AISHELL-1's mean (about
4.5 s: 120,098 training utterances in about 150 h), clipped to the
configuration's frame budget.  Every batch holds the same set of durations,
the ``batch`` quantiles of that log-normal, in an order drawn from the seed:
so every seed and every batch asks for the same work, and a run's rate does
not move with the seed, while each batch still spans short and long
utterances as an unbucketed, shuffled batch does.  Label counts follow the
duration (``chars_per_s``, clipped to ``[1, max_labels]``), label ids are
drawn uniformly from the non-blank vocabulary, and each wave is int16:
uniform noise and a tone, both under a gain that changes every 100 ms, so
that the log-mel moves from frame to frame.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np

SAMPLE_RATE = 16000
HOP = 160
N_FFT = 512
SEGMENT = 1600          # samples under one gain and one tone (100 ms)


def frame_budget(max_frames: int, factor: int):
    """(true-sample capacity, padded length) of a raw wave for a
    ``max_frames``-row feature budget (the on-device-features layout)."""
    raw = (max_frames - 1) * factor + 1
    cap = (raw - 1) * HOP
    return cap, cap + N_FFT


def feature_frames(n_samples, max_frames: int, factor: int):
    """Feature rows of a wave of ``n_samples`` samples: the centred STFT's
    ``1 + n // hop`` frames, stacked and subsampled by ``factor``."""
    raw = np.minimum(1 + np.asarray(n_samples) // HOP, (max_frames - 1) * factor + 1)
    return np.minimum((raw + factor - 1) // factor, max_frames)


def quantile_durations(n: int, mean_s: float, sigma: float, lo_s: float,
                       hi_s: float) -> np.ndarray:
    """The ``n`` mid-quantiles of a log-normal of mean ``mean_s`` and log
    standard deviation ``sigma``, clipped to ``[lo_s, hi_s]`` seconds."""
    mu = math.log(mean_s) - sigma * sigma / 2
    z = NormalDist()
    q = [z.inv_cdf((i + 0.5) / n) for i in range(n)]
    return np.clip(np.exp(mu + sigma * np.asarray(q)), lo_s, hi_s)


@dataclasses.dataclass
class Utterance:
    wave: np.ndarray        # int16, the true samples
    labels: np.ndarray      # int64 label ids, no blank


def seed_words(seed: int, *path: int) -> int:
    """A 63-bit seed for a named stream of the run (``path``) from ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(seed) >> 64, *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Mix:
    """Batches of utterances from a traffic file's parameters and a seed.

    ``p``: the traffic file's ``utterances`` block (``mean_s``, ``sigma``,
    ``chars_per_s``, ``max_labels``, ``amplitude``); ``batch``: rows a
    batch; ``max_frames`` / ``factor``: the configuration's frame budget;
    ``vocab``: the vocabulary size (id 0 is the blank)."""

    def __init__(self, p: Dict, batch: int, max_frames: int, factor: int,
                 vocab: int, seed: int):
        self.p, self.batch, self.vocab, self.seed = p, batch, vocab, seed
        self.max_frames, self.factor = max_frames, factor
        self.cap, self.total = frame_budget(max_frames, factor)
        lo_s = p["min_frames"] * factor * HOP / SAMPLE_RATE
        hi_s = self.cap / SAMPLE_RATE
        d = quantile_durations(batch, p["mean_s"], p["sigma"], lo_s, hi_s)
        self.samples = np.minimum(np.round(d * SAMPLE_RATE).astype(np.int64), self.cap)
        self.n_labels = np.clip(np.round(p["chars_per_s"] * self.samples / SAMPLE_RATE),
                                1, p["max_labels"]).astype(np.int64)

    def utterances(self, index: int) -> List[Utterance]:
        """The rows of batch ``index``, the same for the same seed."""
        rng = np.random.default_rng(seed_words(self.seed, 1, index))
        order = rng.permutation(self.batch)
        samples, n_labels = self.samples[order], self.n_labels[order]
        amp = self.p["amplitude"]
        total = int(samples.sum())
        noise = rng.integers(-amp, amp + 1, total, dtype=np.int32).astype(np.float32)
        n_seg = -(-total // SEGMENT)
        gain = np.repeat(rng.uniform(0.05, 1.0, n_seg).astype(np.float32), SEGMENT)[:total]
        freq = np.repeat(rng.uniform(100.0, 4000.0, n_seg), SEGMENT)[:total]
        tone = np.sin(2 * np.pi * freq * (np.arange(total) / SAMPLE_RATE)).astype(np.float32)
        wave = np.clip(gain * (noise + amp * tone), -32768, 32767).astype(np.int16)
        labels = rng.integers(1, self.vocab, int(n_labels.sum()), dtype=np.int64)
        out, at, lat = [], 0, 0
        for n, u in zip(samples, n_labels):
            out.append(Utterance(wave[at:at + n], labels[lat:lat + u]))
            at, lat = at + n, lat + u
        return out

    def audio_seconds(self) -> float:
        """Seconds of audio in every batch."""
        return float(self.samples.sum()) / SAMPLE_RATE
