"""Streaming recognition sessions (port of ``streaming/session.py``).

Parity surface: ``audio/streamRec_unlimit_dynamic_window.py`` of the
reference.  The session keeps a growing feature pipeline with the
reference's three smoothing rules and decodes receptive-field-exact
encoder windows:

* **feature smoothing**: per ~1 s audio window (15,999 samples, hop 15,519)
  extract masked-log mel and drop the last 3 (incomplete) frames;
* **stack smoothing**: borrow 3 history log-mel frames before stacking,
  then drop the 3 warm-up rows;
* **subsample phase**: align the /3 subsampling to the global frame index;
* **encoder window**: wait for ``n_layer*right`` future frames (or the
  final chunk), take ``n_layer*left`` history frames as a halo, encode
  under the band and keep only the halo-free frames;
* **greedy joint** per effective frame against the label-encoder state of
  the last <= 40 tokens, recomputed on each emission;
* **sentence split** after >= 15 consecutive blank frames.

Like the JAX package this slices the final window's effective frames
correctly where the reference drops the tail, and runs the label encoder
under the causal mask (``decoding/greedy.py``).

On the card: ready windows are padded to the one pinned ``window_len``
(it fixes the rel-position table slice, see :class:`StreamingConfig`) and
encoded together, up to ``MAX_GROUP`` a call, through ``encode_banded``
(the banded attention kernel, one launch a layer for the whole group).
The decode state is threaded through the windows in order by the frame
decoder (:meth:`StreamingSession._frame_decode`), which reads the device
once per emission plus once per window (``host_reads``).

Both model families.  An espnet model (``models/espnet_variant.py``; its
config's ``model.mask`` gives the band and ``seed_token`` = sos = V - 1)
encodes its windows with ``encode_banded``, plain tensor code: its
sinusoidal encodings are shift-invariant, so nothing depends on the window
length, and the incremental mode runs its shift-invariant step.  Its
conv-subsampling input layers raise ``ValueError``: their encoder rows
are not the feature rows the window geometry counts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from transformer_transducer_tpu_torch.decoding.greedy import BLANK, predict_last_state
from transformer_transducer_tpu_torch.models.espnet_variant import is_espnet_config
from transformer_transducer_tpu_torch.ops import features_np as F
from transformer_transducer_tpu_torch.ops.masks import look_ahead_mask
from transformer_transducer_tpu_torch.utils.config import stack_context, subsample_factor
from transformer_transducer_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class StreamingConfig:
    left_context: int = 10
    right_context: int = 2
    n_layer: int = 18
    feature_dim: int = 128
    stack_left: int = 3
    subsample: int = 3
    win_audio: int = 15999
    audio_step: int = 15519
    sample_rate: int = 16000
    label_history: int = 40
    blank_split: int = 15
    seed_token: int = BLANK   # label-history seed: blank (native) / sos (espnet)
    # Fixed encoder window length.  Every window is padded to it, so every
    # window reads one rel-position table slice: the slice depends on the
    # sequence length (the reference takes the LAST klen rows,
    # ``tt/transformer.py:128-135``), and the rel-shift wrap at the in-band
    # future offset j = i+2 reads slice row 0 = ``r_emb[k_len - klen]``.
    # Pinning the length is what makes chunked decoding equal
    # full-sequence decoding exactly.
    window_len: Optional[int] = None
    # Chunk capacity of the incremental (cached-encoder) mode: rows a step;
    # defaults to one audio window's worth of new frames.
    chunk_len: Optional[int] = None

    @classmethod
    def from_config(cls, cfg) -> "StreamingConfig":
        if is_espnet_config(cfg.model):
            return cls(left_context=cfg.model.mask.encoder_left_mask,
                       right_context=cfg.model.mask.encoder_right_mask,
                       n_layer=cfg.model.enc.num_blocks,
                       feature_dim=cfg.data.feature_dim or 128,
                       stack_left=stack_context(cfg.data)[0],
                       subsample=subsample_factor(cfg.data),
                       seed_token=cfg.model.joint.vocab_size - 1)
        return cls(left_context=cfg.model.enc.left_context or 10,
                   right_context=cfg.model.enc.right_context or 2,
                   n_layer=cfg.model.enc.n_layer,
                   feature_dim=cfg.data.feature_dim or 128,
                   stack_left=stack_context(cfg.data)[0],
                   subsample=subsample_factor(cfg.data))

    @property
    def left_len(self) -> int:
        return self.n_layer * self.left_context

    @property
    def right_len(self) -> int:
        return self.n_layer * self.right_context

    @property
    def new_frames(self) -> int:
        # per ~1 s audio window: ~(win_audio/160+1) raw frames /subsample
        return (self.win_audio // 160 + 4) // self.subsample + 2

    def ensure_lengths(self) -> None:
        """Fill the lengths that default from the geometry: ``window_len``
        (halos + one window of new frames, rounded up to a multiple of 64)
        and ``chunk_len`` (one window of new frames, a multiple of 8).
        Keeps values that were set."""
        if self.window_len is None:
            need = self.left_len + self.new_frames + self.right_len
            self.window_len = -(-need // 64) * 64
        if self.chunk_len is None:
            self.chunk_len = -(-self.new_frames // 8) * 8


def check_streamable(model) -> None:
    """An espnet model with a conv-subsampling input layer raises
    ``ValueError``: its encoder rows are fewer than the feature rows the
    window geometry counts."""
    layer = model.encoder.input_layer
    if layer not in (None, "linear"):
        raise ValueError(f"streaming supports espnet input_layer None/'linear', "
                         f"not {layer!r} (conv subsampling changes the "
                         "feature:encoder row rate)")


def advance_window_geometry(pos: int, final_start: Optional[int],
                            total: int, last_clip: bool,
                            cfg: StreamingConfig):
    """The canonical window loop's position bookkeeping (integer arithmetic,
    no decoding): consume every ready window given ``total`` feature rows.
    The window sessions materialise the windows; the incremental session
    runs it as a shadow, since the final window's ``final_start`` pins the
    key clip incremental decoding must reproduce.

    Returns ``(new_pos, new_final_start)``."""
    while True:
        future = total - pos
        if future <= 0 or (not last_clip and future <= cfg.right_len):
            return pos, final_start
        left_frame = min(cfg.left_len, pos)
        start = pos - left_frame
        end = min(total, start + cfg.window_len)
        right_frame = cfg.right_len if (end < total or not last_clip) else 0
        n_eff = (end - start) - left_frame - right_frame
        if n_eff <= 0:
            return pos, final_start
        if right_frame == 0:
            final_start = start
        pos += n_eff


def pack_decode_outputs(toks, splits, confs) -> torch.Tensor:
    """Per-frame tokens, split flags and log-prob confidences as ONE float32
    tensor (``out[0]`` tokens, ``out[1]`` splits, ``out[2]`` confidences;
    token ids and 0/1 flags are exact in float32, vocab << 2^24)."""
    return torch.stack([torch.as_tensor(toks).float(),
                        torch.as_tensor(splits).float(),
                        torch.as_tensor(confs).float()])


class StreamingSession:
    """One stream, decoded as its audio arrives.

    ``model``: a port :class:`~models.transducer.Transducer` or
    :class:`~models.espnet_variant.EspnetTransducer` on ``device`` (``cuda``
    unless the caller passes ``cpu``; without a card it raises).
    ``incremental``: the cached-encoder mode (``streaming/incremental.py``)
    in place of the halo windows; the same tokens.
    """

    MAX_GROUP = 16     # windows encoded in one call at most

    def __init__(self, model, cfg: StreamingConfig,
                 on_token: Optional[Callable[[int, bool], None]] = None,
                 keep_features: bool = False, incremental: bool = False,
                 device=None):
        # keep_features: ALSO accumulate the full subsampled feature stream
        # in ``self.feature_log`` (diagnostics and tests: it grows with the
        # audio; decoding always runs on the trimmed buffers)
        want = resolve_device(device)
        self.device = next(model.parameters()).device
        if self.device.type != want.type:
            raise ValueError(f"the model is on {self.device}, the session "
                             f"asked for {want}")
        check_streamable(model)
        self.model = model
        self.cfg = cfg
        self.on_token = on_token
        self.keep_features = keep_features
        self._d = cfg.feature_dim * (1 + cfg.stack_left)
        cfg.ensure_lengths()
        self.incremental = incremental
        cap = cfg.label_history + 1
        self._label_mask = look_ahead_mask(cap, device=self.device)
        if incremental:
            from transformer_transducer_tpu_torch.streaming.incremental import (
                make_incremental_encoder)
            self._layers, self._inc_geom, self._inc_step = \
                make_incremental_encoder(model, cfg)
        self.reset()

    # ------------------------------------------------------------------
    def reset(self):
        # Host buffers are TRIMMED as they are consumed (a long stream holds
        # O(halo) state, not O(audio history)); the *_base offsets map the
        # absolute positions of the window arithmetic onto the kept tails.
        self.audio = np.empty((0,), dtype=np.int16)
        self._audio_base = 0
        self.log_mel = np.empty((0, self.cfg.feature_dim), dtype=np.float32)
        self.concat_len = 0
        self.subsampled = np.empty((0, self._d), dtype=np.float32)
        self._sub_base = 0
        self.feature_log = (np.empty((0, self._d), dtype=np.float32)
                            if self.keep_features else None)
        self.win_audio_position = 0
        self.win_feature_position = 0
        self.result: List[int] = []
        # per emitted token: the absolute subsampled-frame index it was
        # decoded at (frame period subsample x 10 ms) and its log-softmax
        # probability at that frame
        self.timestamps: List[int] = []
        self.confidences: List[float] = []
        self.segments: List[List[int]] = [[]]
        self._finished = False
        # decode state: the label ring buffer on the device (seed + last
        # <= 40 tokens) with its fill count, the cached label state's joint
        # projection, the blank run and whether anything was emitted; the
        # counts live on the host, which learns each emission anyway
        cap = self.cfg.label_history + 1
        self._buf = torch.zeros((1, cap), dtype=torch.long, device=self.device)
        self._buf[0, 0] = self.cfg.seed_token
        self._count = 1
        self._blank_run = 0
        self._emitted_any = False
        self._dec_proj = None
        # what the decoder costs: device reads, windows (or incremental
        # steps) decoded, encoder calls (window groups)
        self.host_reads = 0
        self.windows = 0
        self.window_groups = 0
        if self.incremental:
            from transformer_transducer_tpu_torch.streaming.incremental import (
                init_cache)
            n_layer, d_model = self._inc_geom
            self._cache = init_cache(n_layer, self.cfg.left_context,
                                     self.cfg.right_context, d_model, self.device)
            self._fed = 0               # rows fed to the encoder
            self._shadow_pos = 0        # canonical window-geometry mirror
            self._shadow_final_start = None

    # ------------------------------------------------------------------
    def _label_proj(self) -> torch.Tensor:
        """The label half of the joint's first layer at the current label
        state (the label encoder over the ring buffer)."""
        dec = predict_last_state(self.model, self._buf, self._count, self._label_mask)
        return self.model.joint.project_dec(dec)

    def _frame_decode(self, enc_eff: torch.Tensor, abs_start: int) -> torch.Tensor:
        """Emission-driven greedy joint over one window's ``n_eff`` encoder
        rows (shared by the window and incremental paths); returns the
        window's packed outputs (``pack_decode_outputs``, on the host).

        Greedy RNN-T changes state only on a NON-BLANK emission: while the
        label state is fixed the per-frame argmax is a function of the
        frame alone.  So one batched joint over the rows not yet decided
        finds the next emitting frame, and the loop jumps to it: (#emissions
        + 1) joints a window, each one read of the device (the emitting row,
        its token and confidence packed into one transfer).  The label
        state is recomputed only on an emission.  Numerics equal the
        per-frame loop's: at most one emission a frame (reference
        ``audio/streamRec_unlimit_dynamic_window.py:187-207``).  The
        batched-joint detection is WIND's (arXiv:2505.13765).
        """
        cfg = self.cfg
        cap = cfg.label_history + 1
        n = enc_eff.shape[0]
        toks, splits, confs = [0] * n, [0] * n, [0.0] * n
        if self._dec_proj is None:
            self._dec_proj = self._label_proj()
        # the joint's first layer: its encoder half once a window, its label
        # half once an emission (an int8 joint has no halves: it takes the
        # concatenation, as the JAX session's joint_logits does)
        enc_proj = self.model.joint.project_enc(enc_eff)
        t = 0
        while t < n:
            logits = self.model.joint_logits_from(
                self.model.joint.first_layer(enc_proj[t:], self._dec_proj))
            preds = logits.argmax(-1)
            rows = torch.arange(n - t, device=logits.device)
            first = torch.where(preds != BLANK, rows, n - t).min()
            i = first.clamp(max=n - t - 1)
            row, pred = logits[i], preds[i]
            conf = row[pred] - torch.logsumexp(row, 0)
            first, pred, conf = torch.stack([first.float(), pred.float(), conf]).tolist()
            self.host_reads += 1
            first, pred = int(first), int(pred)
            if first == n - t:                      # the rest is blank
                if self._emitted_any:
                    self._blank_run += n - t
                break
            emit_t = t + first
            # frames [t, emit_t) are blank under this label state
            if self._emitted_any:
                self._blank_run += first
            split = self._emitted_any and self._blank_run >= cfg.blank_split
            toks[emit_t], splits[emit_t], confs[emit_t] = pred, int(split), conf
            # ring append: shift the history left once the buffer is full
            if self._count < cap:
                self._buf[0, self._count] = pred
            else:
                self._buf = torch.cat([self._buf[:, :1], self._buf[:, 2:],
                                       self._buf.new_full((1, 1), pred)], dim=1)
            self._count = min(self._count + 1, cap)
            self._dec_proj = self._label_proj()
            self._blank_run = 0
            self._emitted_any = True
            t = emit_t + 1
        self.windows += 1
        return pack_decode_outputs(toks, splits, confs)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def accept_waveform(self, samples: np.ndarray) -> List[int]:
        """Append int16 samples; returns tokens newly emitted by processing
        any complete audio windows."""
        assert not self._finished, "session finished; call reset()"
        self.audio = np.concatenate([self.audio, samples.astype(np.int16)])
        # ingest features for EVERY complete audio window first (host
        # numpy), THEN decode: when audio arrives faster than real time,
        # the ready windows are encoded together
        audio_total = self._audio_base + len(self.audio)
        while (self.win_audio_position + self.cfg.win_audio) <= audio_total:
            rel = self.win_audio_position - self._audio_base
            win = self.audio[rel:rel + self.cfg.win_audio]
            self._ingest_audio_window(win, last_clip=False)
            self.win_audio_position += self.cfg.audio_step
        # trim consumed audio (finalize still needs the tail)
        drop = self.win_audio_position - self._audio_base
        if drop > 0:
            self.audio = self.audio[drop:]
            self._audio_base = self.win_audio_position
        return self._process_feature_windows(last_clip=False)

    @torch.no_grad()
    def finalize(self) -> List[int]:
        """Flush the remaining audio (the reference's ``last_clip`` path)."""
        assert not self._finished
        self._finished = True
        tail = self.audio[self.win_audio_position - self._audio_base:]
        if len(tail) >= 512:  # >= one FFT window of audio
            self._ingest_audio_window(tail, last_clip=True)
        return self._process_feature_windows(last_clip=True)

    # ------------------------------------------------------------------
    def _ingest_audio_window(self, win_audio: np.ndarray, last_clip: bool) -> None:
        cfg = self.cfg
        # 1. feature smoothing: drop the 3 frames whose audio is incomplete
        feats = F.logmel_masked(win_audio, cfg.sample_rate, cfg.feature_dim)
        if not last_clip:
            feats = feats[:-3]
        n_new = feats.shape[0]
        if n_new <= 0:
            return
        # 2. stack smoothing: borrow `stack_left` history frames (only that
        # many log-mel rows are ever read again: keep just the tail)
        borrow = cfg.stack_left
        src = np.concatenate([self.log_mel, feats])[-borrow - n_new:]
        stacked = F.stack_frames(src, borrow, 0)[src.shape[0] - n_new:]
        self.log_mel = src[-borrow:] if borrow else src[:0]
        # 3. subsample phase alignment: resume at the first ABSOLUTE index
        # >= `before` that is a multiple of the subsample factor
        before = self.concat_len
        off = (-before) % cfg.subsample
        new_sub = stacked[off::cfg.subsample]
        self.concat_len = before + n_new
        self.subsampled = np.concatenate([self.subsampled, new_sub])
        if self.feature_log is not None:
            self.feature_log = np.concatenate([self.feature_log, new_sub])

    def _process_feature_windows(self, last_clip: bool) -> List[int]:
        if self.incremental:
            return self._process_incremental(last_clip)
        cfg = self.cfg
        # gather the ready windows (their geometry is host arithmetic),
        # decoding each full group as it fills so host memory stays
        # O(group), not O(audio length)
        emitted: List[int] = []
        ready = []
        while True:
            total = self._sub_base + self.subsampled.shape[0]
            future = total - self.win_feature_position
            if future <= 0 or (not last_clip and future <= cfg.right_len):
                break
            left_frame = min(cfg.left_len, self.win_feature_position)
            start = self.win_feature_position - left_frame
            end = min(total, start + cfg.window_len)
            # frames cut off by the window cap still need their right halo
            right_frame = cfg.right_len if (end < total or not last_clip) else 0
            window = self.subsampled[start - self._sub_base:end - self._sub_base]
            n_eff = window.shape[0] - left_frame - right_frame
            if n_eff <= 0:
                break
            ready.append((window, left_frame, n_eff, self.win_feature_position))
            self.win_feature_position += n_eff
            if len(ready) == self.MAX_GROUP:
                emitted += self._decode_windows(ready)
                ready = []
        emitted += self._decode_windows(ready)
        # trim feature frames older than the next window's left halo
        drop = (self.win_feature_position - cfg.left_len) - self._sub_base
        if drop > 0:
            self.subsampled = self.subsampled[drop:]
            self._sub_base += drop
        return emitted

    def _decode_windows(self, ready) -> List[int]:
        """Decode ``(window, left_frame, n_eff, abs_start)`` tuples: each
        group of up to ``MAX_GROUP`` windows, zero-padded to ``window_len``,
        is encoded in one ``encode_banded`` call; the decode state then
        runs through the windows in order."""
        cfg = self.cfg
        emitted = []
        for base in range(0, len(ready), self.MAX_GROUP):
            group = ready[base:base + self.MAX_GROUP]
            windows = np.zeros((len(group), cfg.window_len, self._d), np.float32)
            for j, (window, _, _, _) in enumerate(group):
                windows[j, :window.shape[0]] = window
            enc = self.model.encode_banded(torch.from_numpy(windows).to(self.device),
                                           cfg.left_context, cfg.right_context)
            self.window_groups += 1
            for j, (_, left_frame, n_eff, abs_start) in enumerate(group):
                out = self._frame_decode(enc[j, left_frame:left_frame + n_eff],
                                         abs_start)
                emitted += self._emit(out[0], out[1], abs_start, out[2])
        return emitted

    # ----- incremental (cached-encoder) feed path ---------------------
    def _advance_shadow(self, total: int, last_clip: bool) -> None:
        """Mirror the canonical window loop's feature-position bookkeeping
        (no decoding) so the final window's key clip, the one place window
        geometry reaches the numerics, is reproduced under the same feed
        pattern."""
        self._shadow_pos, self._shadow_final_start = advance_window_geometry(
            self._shadow_pos, self._shadow_final_start, total, last_clip, self.cfg)

    def _process_incremental(self, last_clip: bool) -> List[int]:
        """Feed pending feature rows (plus, at finalize, ``right_len`` zero
        flush rows that push the last outputs through the layers) to the
        cached encoder in ``chunk_len`` steps and decode the output rows
        that emerge.  Output position p becomes decodable once the feature
        frontier reaches ``p + right_len``, the window path's readiness
        rule (its ``future > right_len`` gate), so tokens and their order
        are the same."""
        from transformer_transducer_tpu_torch.streaming.incremental import _BIG
        cfg = self.cfg
        lag = cfg.right_len
        total = self._sub_base + self.subsampled.shape[0]
        self._advance_shadow(total, last_clip)
        if total == 0:
            return []
        pend = self.subsampled[self._fed - self._sub_base:]
        if last_clip:
            # the canonical final window clips keys at its padded capacity
            key_limit = (self._shadow_final_start + cfg.window_len
                         if self._shadow_final_start is not None else total + lag)
            pend = np.concatenate([pend, np.zeros((lag, self._d), np.float32)])
        else:
            key_limit = _BIG
        emitted: List[int] = []
        for p in range(0, pend.shape[0], cfg.chunk_len):
            rows = pend[p:p + cfg.chunk_len]
            out_start = (self._fed + p) - lag
            valid_start = max(0, -out_start)
            n_valid = max(0, min(rows.shape[0] - valid_start,
                                 total - (out_start + valid_start)))
            self._cache, out, _ = self._inc_step(
                self._layers, self._cache, torch.from_numpy(rows).to(self.device),
                key_limit)
            if n_valid > 0:
                abs_start = out_start + valid_start
                packed = self._frame_decode(out[valid_start:valid_start + n_valid],
                                            abs_start)
                emitted += self._emit(packed[0], packed[1], abs_start, packed[2])
        self._fed += pend.shape[0]
        # fed rows are never read again from the host buffer
        drop = min(self._fed, total) - self._sub_base
        if drop > 0:
            self.subsampled = self.subsampled[drop:]
            self._sub_base += drop
        return emitted

    def _emit(self, toks, splits, abs_start: int, confs) -> List[int]:
        emitted = []
        for idx, (tok, split) in enumerate(zip(toks.tolist(), splits.tolist())):
            if tok == 0:
                continue
            tok = int(tok)
            if split and self.segments[-1]:
                self.segments.append([])
            self.result.append(tok)
            self.timestamps.append(abs_start + idx)
            self.confidences.append(float(confs[idx]))
            self.segments[-1].append(tok)
            emitted.append(tok)
            if self.on_token is not None:
                self.on_token(tok, bool(split))
        return emitted


@torch.no_grad()
def chunked_encode(model, features: np.ndarray, cfg: StreamingConfig,
                   step: Optional[int] = None,
                   fixed_len: Optional[int] = None) -> np.ndarray:
    """Chunk-by-chunk banded encoding (``encode_banded``, on the model's
    device) of a full feature sequence with receptive-field halos.  With
    every window padded to ``fixed_len`` this equals full-sequence banded
    encoding at the same padded length (see ``StreamingConfig.window_len``
    for why the length must be pinned)."""
    device = next(model.parameters()).device
    t = features.shape[0]
    step = step or max(cfg.right_len, 1)
    fixed_len = fixed_len or (cfg.left_len + step + cfg.right_len)
    out = []
    pos = 0
    while pos < t:
        end = min(pos + step + cfg.right_len, t)
        left_frame = min(cfg.left_len, pos)
        start = pos - left_frame
        right_frame = cfg.right_len if end < t else 0
        window = features[start:end]
        assert window.shape[0] <= fixed_len
        padded = np.zeros((1, fixed_len, features.shape[1]), dtype=np.float32)
        padded[0, :window.shape[0]] = window
        enc = model.encode_banded(torch.from_numpy(padded).to(device),
                                  cfg.left_context, cfg.right_context)[0]
        effective = enc[left_frame:window.shape[0] - right_frame]
        out.append(effective.cpu().numpy())
        pos += effective.shape[0]
    return np.concatenate(out, axis=0)


class TrapezoidStreamingSession(StreamingSession):
    """Fixed trapezoid-window variant (reference ``audio/streamRec.py``).

    The feature window GROWS from ``min_win = pred_frame + n_layer*right``
    to ``max_win = n_layer*left + pred_frame + n_layer*right`` by
    ``pred_frame`` a step, then SLIDES by ``pred_frame``.  Each step decodes
    the ``pred_frame`` frames that sit ``min_win`` from the window end
    (they have the required future context; while the window grows their
    left history is short: v1 is approximate by design, which is why the
    reference replaced it with the dynamic window).  Every window is padded
    to ``window_len`` and encoded alone.

    Divergence: the reference's v1 drops the audio tail when recording
    stops mid-window; ``finalize`` here decodes it (right halo 0).
    """

    def __init__(self, model, cfg: StreamingConfig, pred_frame: int = 18, **kwargs):
        if kwargs.get("incremental"):
            raise ValueError("the trapezoid (v1) session has no incremental "
                             "mode; use StreamingSession")
        self.pred_frame = pred_frame
        self.min_win = pred_frame + cfg.right_len
        self.max_win = cfg.left_len + pred_frame + cfg.right_len
        if cfg.window_len is None:
            cfg.window_len = -(-self.max_win // 64) * 64
        super().__init__(model, cfg, **kwargs)

    def reset(self):
        super().reset()
        self.win_len = self.min_win

    def _process_feature_windows(self, last_clip: bool) -> List[int]:
        emitted = []
        while True:
            total = self._sub_base + self.subsampled.shape[0]
            if self.win_feature_position + self.win_len <= total:
                rel = self.win_feature_position - self._sub_base
                window = self.subsampled[rel:rel + self.win_len]
                eff_start = self.win_len - self.min_win
                emitted += self._decode_windows([(
                    window, eff_start, self.pred_frame,
                    self.win_feature_position + eff_start)])
                if self.win_len < self.max_win:
                    self.win_len += self.pred_frame
                else:
                    self.win_feature_position += self.pred_frame
            elif last_clip:
                # decode the remaining tail (v1 drops it; see the docstring)
                consumed = self.win_feature_position + self.win_len - self.min_win
                if consumed >= total:
                    break
                start = max(0, self.win_feature_position)
                window = self.subsampled[start - self._sub_base:total - self._sub_base]
                eff_start = consumed - start
                n_eff = window.shape[0] - eff_start
                if n_eff <= 0:
                    break
                emitted += self._decode_windows([(window, eff_start, n_eff, consumed)])
                self.win_feature_position = total
            else:
                break
        # the sliding window never reads frames before its current start
        drop = self.win_feature_position - self._sub_base
        if drop > 0:
            self.subsampled = self.subsampled[drop:]
            self._sub_base += drop
        return emitted
