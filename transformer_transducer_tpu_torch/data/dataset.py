"""CSV-driven audio dataset with host feature extraction (port of
``data/dataset.py``, host-feature path).

Reference ``AudioDataset`` (``tt/dataset.py:72-120``): CSV rows of
``file_path,label`` -> wav read -> log10-eps mel (``get_feature2``) -> frame
stack (left, right) -> subsample -> pad to the fixed
``max_input_length``/``max_target_length``; labels char-encoded with an
``<unk>`` fallback; target padding value ``ignore_id`` (0 when unset).
``data.short_first`` sorts the training rows by label length.

Waveform augmentation (``ops/augment.py``), the on-device frontend
(``ops/features.py``) and per-speaker CMVN (``data/kaldiio.py``) are ported
in a later slice; asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import csv
from typing import List, Tuple

import numpy as np

from transformer_transducer_tpu_torch.data.wav import read_wave
from transformer_transducer_tpu_torch.ops import features_np as F
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


class AudioDataset:
    """Items are ``(features (max_input_length, F) float32, t_len,
    targets (max_target_length,) int64, u_len)``."""

    def __init__(self, data_cfg, split: str, vocab: Vocabulary,
                 augment: bool = False, cmvn=None,
                 on_device_features: bool = False):
        if augment:
            raise NotImplementedError(
                "waveform augmentation (ops/augment.py) is ported in a later "
                "slice of the PyTorch port")
        if on_device_features:
            raise NotImplementedError(
                "the on-device frontend (ops/features.py) is ported in a later "
                "slice of the PyTorch port")
        if cmvn is not None:
            raise NotImplementedError(
                "CMVN (data/kaldiio.py) is ported in a later slice of the "
                "PyTorch port")
        self.cfg = data_cfg
        self.vocab = vocab
        self.rows = read_manifest(data_cfg[split])
        self.feature_dim = data_cfg.feature_dim or 128
        self.left, self.right = stack_context(data_cfg)
        self.subsample = subsample_factor(data_cfg)
        self.max_input_length = data_cfg.max_input_length
        self.max_target_length = data_cfg.max_target_length
        self.ignore_id = data_cfg.ignore_id or 0
        if data_cfg.short_first and split == "train":
            self.rows.sort(key=lambda r: len(r[1]))

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int):
        path, label = self.rows[index]
        targets = np.asarray(self.vocab.encode(label), dtype=np.int64)
        wave, rate = read_wave(path)
        feats = F.logmel_eps(wave, rate, self.feature_dim)
        feats = F.subsample(F.stack_frames(feats, self.left, self.right),
                            self.subsample)

        t_len = min(feats.shape[0], self.max_input_length)
        u_len = min(len(targets), self.max_target_length)
        feats_pad = np.zeros((self.max_input_length, feats.shape[1]), np.float32)
        feats_pad[:t_len] = feats[:t_len]
        tgt_pad = np.full((self.max_target_length,), self.ignore_id, np.int64)
        tgt_pad[:u_len] = targets[:u_len]
        return feats_pad, np.int64(t_len), tgt_pad, np.int64(u_len)
