"""CSV-driven audio dataset with on-the-fly feature extraction (port of
``data/dataset.py``).

Reference ``AudioDataset`` (``tt/dataset.py:72-120``): CSV rows of
``file_path,label`` -> wav read -> log10-eps mel (``get_feature2``) -> frame
stack (left, right) -> subsample -> pad to the fixed
``max_input_length``/``max_target_length``; labels char-encoded with an
``<unk>`` fallback; target padding value ``ignore_id`` (0 when unset).
``data.short_first`` sorts the training rows by label length.  Optional
per-speaker kaldi CMVN (``tt/dataset.py:26-34,61-69``) on the log-mel, and
optional waveform augmentation (``ops/augment.py``), seeded per item so
that the waves equal the JAX package's to the bit.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Tuple

import numpy as np

from transformer_transducer_tpu_torch.data.wav import read_wave
from transformer_transducer_tpu_torch.ops import features_np as F
from transformer_transducer_tpu_torch.ops.augment import audio_augment
from transformer_transducer_tpu_torch.ops.features import padded_wave_samples
from transformer_transducer_tpu_torch.utils.config import (
    stack_context, subsample_factor)
from transformer_transducer_tpu_torch.utils.vocab import Vocabulary


def read_manifest(path: str) -> List[Tuple[str, str]]:
    """CSV with a ``file_path,label`` header (a headerless file keeps its
    first row)."""
    rows = []
    with open(path, "r", encoding="utf-8") as fh:
        reader = csv.reader(fh)
        header = next(reader, None)
        if header and header[0] != "file_path":
            rows.append((header[0], header[1]))
        for row in reader:
            if row:
                rows.append((row[0], row[1]))
    return rows


def pad_raw_wave(wave: np.ndarray, cap: int, total: int):
    """``(padded wave, true sample count)`` in the on-device-features layout
    (``ops/features.py::padded_wave_samples``): ``n_fft // 2`` reflected
    head, at most ``cap`` true samples, ``n_fft // 2`` reflected tail, zeros
    to ``total``.  The reflect over the true signal reproduces the centred
    STFT's edge of the host pipeline; the zeros never reach a valid frame's
    window.  An utterance over ``cap`` is clipped before the tail reflect,
    so its last feature row can differ from the host path's (which clips
    rows); both drop the same audio.  int16 waves stay int16, others become
    float32."""
    half = F.N_FFT // 2
    wave = np.asarray(wave)
    if wave.dtype != np.int16:     # augmented waves: ship f32, not f64
        wave = wave.astype(np.float32)
    n = min(len(wave), cap)
    wave = wave[:n]
    if n < half + 1:   # an utterance shorter than a window: zero-extend
        wave = np.pad(wave, (0, half + 1 - n))
    out = np.zeros((total,), wave.dtype)
    out[:half] = wave[1:half + 1][::-1]
    out[half:half + len(wave)] = wave
    out[half + len(wave):half + len(wave) + half] = wave[-half - 1:-1][::-1]
    return out, np.int64(n)


class CMVN:
    """Per-speaker cepstral mean/variance normalization from kaldi-format
    stats (``data/kaldiio.py::cmvn_stats``; reference
    ``tt/dataset.py:26-34,61-69``), keyed by utterance id (the row's path)."""

    def __init__(self, utt2spk: Dict[str, str], stats: Dict[str, np.ndarray]):
        self.utt2spk = utt2spk
        self.stats = stats

    def __call__(self, utt_id: str, mat: np.ndarray) -> np.ndarray:
        st = self.stats[self.utt2spk[utt_id]]
        count = st[0, -1]
        mean = st[0, :-1] / count
        var = st[1, :-1] / count - mean ** 2
        return (mat - mean) / np.sqrt(var)


class AudioDataset:
    """Items are ``(features (max_input_length, F) float32, t_len,
    targets (max_target_length,) int64, u_len)``.

    With ``on_device_features`` (``data.on_device_features``) they are raw
    waves instead: ``(padded wave, true sample count, targets, u_len)``,
    the wave int16 (float32 when augmented) in the layout of
    ``ops/features.py::padded_wave_samples``; the train step and the
    evaluation featurize on the card (``extract_batch_padded``).  CMVN is
    host feature math and is rejected in that mode, as in the JAX package.

    With ``augment`` each item's wave goes through ``audio_augment`` with a
    generator seeded by ``SeedSequence([seed, index, loader_epoch])``; the
    loader publishes ``loader_epoch`` every epoch.
    """

    def __init__(self, data_cfg, split: str, vocab: Vocabulary,
                 augment: bool = False, seed: int = 0,
                 cmvn: Optional[CMVN] = None,
                 on_device_features: bool = False):
        self.cfg = data_cfg
        self.vocab = vocab
        self.rows = read_manifest(data_cfg[split])
        self.feature_dim = data_cfg.feature_dim or 128
        self.left, self.right = stack_context(data_cfg)
        self.subsample = subsample_factor(data_cfg)
        self.max_input_length = data_cfg.max_input_length
        self.max_target_length = data_cfg.max_target_length
        self.ignore_id = data_cfg.ignore_id or 0
        self.augment = augment
        # a generator per (utterance, epoch): __getitem__ runs in the
        # loader's threads, and numpy generators are not thread-safe
        self._seed = seed
        self.loader_epoch = 0
        self.cmvn = cmvn
        if data_cfg.short_first and split == "train":
            self.rows.sort(key=lambda r: len(r[1]))
        self.on_device_features = on_device_features
        if on_device_features:
            if cmvn is not None:
                raise NotImplementedError(
                    "data.on_device_features does not compose with CMVN "
                    "(host-side per-speaker feature stats); disable one")
            self._wave_cap, self._wave_total = padded_wave_samples(
                self.max_input_length, self.subsample)

    def __len__(self) -> int:
        return len(self.rows)

    def _read(self, index: int):
        path, label = self.rows[index]
        targets = np.asarray(self.vocab.encode(label), dtype=np.int64)
        wave, rate = read_wave(path)
        if self.augment:
            rng = np.random.default_rng(
                np.random.SeedSequence([self._seed, index, self.loader_epoch]))
            wave = audio_augment(rng, wave)
        return wave, rate, targets

    def _pad_targets(self, targets: np.ndarray):
        u_len = min(len(targets), self.max_target_length)
        tgt_pad = np.full((self.max_target_length,), self.ignore_id, np.int64)
        tgt_pad[:u_len] = targets[:u_len]
        return tgt_pad, np.int64(u_len)

    def _raw_item(self, index: int):
        """The raw-wave item (layout: :func:`pad_raw_wave`)."""
        wave, _, targets = self._read(index)
        out, n = pad_raw_wave(wave, self._wave_cap, self._wave_total)
        tgt_pad, u_len = self._pad_targets(targets)
        return out, n, tgt_pad, u_len

    def __getitem__(self, index: int):
        if self.on_device_features:
            return self._raw_item(index)
        wave, rate, targets = self._read(index)
        feats = F.logmel_eps(wave, rate, self.feature_dim)
        if self.cmvn is not None:
            feats = self.cmvn(self.rows[index][0], feats)
        feats = F.subsample(F.stack_frames(feats, self.left, self.right),
                            self.subsample)

        t_len = min(feats.shape[0], self.max_input_length)
        feats_pad = np.zeros((self.max_input_length, feats.shape[1]), np.float32)
        feats_pad[:t_len] = feats[:t_len]
        tgt_pad, u_len = self._pad_targets(targets)
        return feats_pad, np.int64(t_len), tgt_pad, u_len
