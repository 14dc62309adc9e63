"""Batched multi-stream streaming recognition (port of ``streaming/batched.py``).

``BatchedStreamingSession`` serves N streams at once: N feature pipelines
on the host, and per serving round one encoder call over the windows (or
cached-encoder chunks) of the streams that have one, then one frame
decoder over those streams together.  Each stream's output equals a solo
:class:`~streaming.session.StreamingSession` fed the same audio (same
smoothing rules, halos, label-history ring, blank-run splits).

Where the JAX package encodes all N slots of a round (idle ones as no-ops)
and pads a drain to a bucket of rounds, because XLA compiles one program a
shape, the port encodes only the windows that exist, each padded to the
pinned ``window_len``, through ``encode_banded`` (the banded attention
kernel, one launch a layer for the whole call).  A drain gathers up to
``MAX_ROUNDS`` rounds (their geometry is host arithmetic), encodes all their
windows in one call and then decodes them round by round.

The frame decoder is the solo session's emission jump (WIND,
arXiv:2505.13765) over N streams: one joint over the undecided rows of the
streams still active, one packed read of each stream's next emitting row,
token and confidence; only the streams that emitted run the label encoder
again (one batched call) and are scored again.  A round reads the device at
most 1 + the most emissions of one stream in it (``host_reads`` against
``read_bound``).  The label state of a stream is a pure function of its
ring, so resetting a slot touches no other stream's state.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from transformer_transducer_tpu_torch.decoding.greedy import BLANK, predict_last_state
from transformer_transducer_tpu_torch.ops import features_np as F
from transformer_transducer_tpu_torch.ops.masks import look_ahead_mask
from transformer_transducer_tpu_torch.streaming.session import (
    StreamingConfig, advance_window_geometry, check_streamable)
from transformer_transducer_tpu_torch.utils.device import resolve_device


class _StreamState:
    """Host-side feature pipeline of one stream.  Buffers are trimmed as
    consumed (positions are ABSOLUTE, the ``*_base`` offsets map them onto
    the retained tails), so a long-lived stream holds O(halo) host state."""

    def __init__(self, cfg: StreamingConfig, d: int):
        self.audio = np.empty((0,), dtype=np.int16)
        self.audio_base = 0
        self.log_mel = np.empty((0, cfg.feature_dim), dtype=np.float32)
        self.concat_len = 0
        self.subsampled = np.empty((0, d), dtype=np.float32)
        self.sub_base = 0
        self.win_audio_position = 0
        self.win_feature_position = 0
        self.result: List[int] = []
        # per token: the absolute subsampled-frame index it was decoded at
        # and its log-softmax probability there
        self.timestamps: List[int] = []
        self.confidences: List[float] = []
        self.segments: List[List[int]] = [[]]
        self.finished = False
        # incremental mode: rows fed to the encoder, the canonical window
        # geometry's mirror, the final key clip and flush rows still due
        self.fed = 0
        self.shadow_pos = 0
        self.shadow_final_start = None
        self.flushed = False
        self.key_limit = None
        self.pending_flush = 0


class BatchedStreamingSession:
    """N streams decoded together, round by round.

    ``model``: a port :class:`~models.transducer.Transducer` or
    :class:`~models.espnet_variant.EspnetTransducer` on ``device`` (``cuda``
    unless the caller passes ``cpu``; without a card it raises).
    ``incremental``: cached-encoder rounds (``streaming/incremental.py``'s
    batched step of the model's family) in place of the halo windows; the
    same tokens.
    """

    MAX_ROUNDS = 16    # rounds a drain gathers, encodes and decodes as one group

    def __init__(self, model, cfg: StreamingConfig, n_streams: int,
                 incremental: bool = False, device=None):
        want = resolve_device(device)
        self.device = next(model.parameters()).device
        if self.device.type != want.type:
            raise ValueError(f"the model is on {self.device}, the session "
                             f"asked for {want}")
        check_streamable(model)
        self.model = model
        self.cfg = cfg
        self.n = n_streams
        self._d = cfg.feature_dim * (1 + cfg.stack_left)
        cfg.ensure_lengths()
        self.incremental = incremental
        self._label_mask = look_ahead_mask(cfg.label_history + 1, device=self.device)
        if incremental:
            from transformer_transducer_tpu_torch.streaming.incremental import (
                make_incremental_encoder)
            self._layers, self._inc_geom, self._inc_step = make_incremental_encoder(
                model, cfg, batched=True)
        self.reset()

    @torch.no_grad()
    def reset(self):
        cfg = self.cfg
        self.streams = [_StreamState(cfg, self._d) for _ in range(self.n)]
        # decode state: the label rings on the device (seed + last <= 40
        # tokens) with each stream's label projection; fill counts, blank
        # runs and whether a stream emitted live on the host, which learns
        # each emission anyway
        self._buf = torch.zeros((self.n, cfg.label_history + 1), dtype=torch.long,
                                device=self.device)
        self._buf[:, 0] = cfg.seed_token
        self._count = np.ones((self.n,), np.int64)
        self._blank_run = np.zeros((self.n,), np.int64)
        self._emitted_any = np.zeros((self.n,), np.bool_)
        ones = torch.ones((self.n,), dtype=torch.long, device=self.device)
        self._dec_proj = self._label_proj(torch.arange(self.n, device=self.device), ones)
        # what serving costs: rounds decoded, device reads and their bound
        # (1 + the most emissions of one stream, summed over rounds),
        # encoder calls and the windows (or chunks) they encoded
        self.rounds = 0
        self.host_reads = 0
        self.read_bound = 0
        self.encode_calls = 0
        self.windows = 0
        if self.incremental:
            from transformer_transducer_tpu_torch.streaming.incremental import (
                init_batched_cache)
            n_layer, d_model = self._inc_geom
            self._cache = init_batched_cache(self.n, n_layer, cfg.left_context,
                                             cfg.right_context, d_model, self.device)

    # ------------------------------------------------------------------
    def _label_proj(self, ids: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        """The label half of the joint's first layer for streams ``ids``
        (the label encoder over their rings, ``count`` tokens each)."""
        dec = predict_last_state(self.model, self._buf[ids], count, self._label_mask)
        return self.model.joint.project_dec(dec)

    def _push_labels(self, slots: List[int], toks: List[int]) -> None:
        """Append each emitted token to its stream's ring (shifting the
        history once the ring is full) and recompute those streams' label
        projections in one call."""
        cap = self.cfg.label_history + 1
        before = self._count[slots]
        ids, tok, cnt = torch.from_numpy(np.stack([slots, toks, before])).to(self.device)
        rows = self._buf[ids]
        appended = rows.scatter(1, cnt.clamp(max=cap - 1)[:, None], tok[:, None])
        shifted = torch.cat([rows[:, :1], rows[:, 2:], tok[:, None]], dim=1)
        self._buf[ids] = torch.where((cnt < cap)[:, None], appended, shifted)
        self._count[slots] = np.minimum(before + 1, cap)
        self._dec_proj[ids] = self._label_proj(ids, (cnt + 1).clamp(max=cap))

    def _decode_round(self, rows: torch.Tensor, segs) -> List[List[int]]:
        """The emission-driven greedy joint over one round: ``rows`` (R, D)
        holds the encoder rows of the round's streams one after another,
        ``segs`` a ``(slot, n_rows, abs_start)`` per stream in that order.
        Records the tokens in the streams; returns the new tokens a slot.

        Greedy RNN-T changes a stream's state only on a non-blank emission,
        so one joint over every active stream's undecided rows finds each
        one's next emitting row (as the solo session's ``_frame_decode``
        does for one stream).  Blank runs, splits and ring shifts follow the
        solo session's rules stream by stream."""
        cfg = self.cfg
        out: List[List[int]] = [[] for _ in range(self.n)]
        lens = np.array([n for _, n, _ in segs], np.int64)
        starts = np.cumsum(lens) - lens
        t = np.zeros_like(lens)                     # next undecided row a stream
        emits = np.zeros_like(lens)
        active = np.flatnonzero(lens > 0)
        enc_proj = self.model.joint.project_enc(rows)
        reads = 0
        while active.size:
            slots = np.array([segs[a][0] for a in active], np.int64)
            remaining = lens[active] - t[active]
            base, slot_t, left_t = torch.from_numpy(
                np.stack([starts[active] + t[active], slots, remaining])).to(self.device)
            n_rows = int(remaining.sum())
            seg = torch.repeat_interleave(torch.arange(active.size, device=self.device),
                                          left_t, output_size=n_rows)
            offs = torch.cumsum(left_t, 0) - left_t
            local = torch.arange(n_rows, device=self.device) - offs[seg]
            logits = self.model.joint_logits_from(self.model.joint.first_layer(
                enc_proj[base[seg] + local], self._dec_proj[slot_t][seg]))
            preds = logits.argmax(-1)
            cand = torch.where(preds != BLANK, local, n_rows)
            first = torch.full((active.size,), n_rows, dtype=torch.long,
                               device=self.device).scatter_reduce(0, seg, cand, "amin")
            first = torch.minimum(first, left_t)    # == remaining: the rest is blank
            pos = offs + torch.minimum(first, left_t - 1)
            row, pred = logits[pos], preds[pos]
            conf = row.gather(1, pred[:, None])[:, 0] - torch.logsumexp(row, -1)
            first, pred, conf = torch.stack([first.float(), pred.float(), conf]).tolist()
            reads += 1
            emitted, toks, still = [], [], []
            for j, a in enumerate(active):
                slot, f = int(slots[j]), int(first[j])
                st = self.streams[slot]
                had = bool(self._emitted_any[slot])
                if had:                             # the blank run counts after a token
                    self._blank_run[slot] += f
                if f == remaining[j]:               # the rest is blank
                    continue
                frame = int(t[a]) + f
                tok = int(pred[j])
                if had and self._blank_run[slot] >= cfg.blank_split and st.segments[-1]:
                    st.segments.append([])
                st.result.append(tok)
                st.timestamps.append(segs[a][2] + frame)
                st.confidences.append(conf[j])
                st.segments[-1].append(tok)
                out[slot].append(tok)
                emitted.append(slot)
                toks.append(tok)
                self._blank_run[slot] = 0
                self._emitted_any[slot] = True
                emits[a] += 1
                t[a] = frame + 1
                if t[a] < lens[a]:
                    still.append(a)
            if emitted:
                self._push_labels(emitted, toks)
            active = np.array(still, np.int64)
        self.rounds += 1
        self.host_reads += reads
        self.read_bound += 1 + int(emits.max(initial=0))
        return out

    # ------------------------------------------------------------------
    def accept_waveform(self, stream: int, samples: np.ndarray) -> None:
        st = self.streams[stream]
        if st.finished:
            raise ValueError(f"stream {stream} is finalized; reset_streams([{stream}])")
        st.audio = np.concatenate([st.audio, samples.astype(np.int16)])

    def finalize(self, stream: int) -> None:
        self.streams[stream].finished = True

    def _advance_features(self, st: _StreamState) -> None:
        cfg = self.cfg
        while True:
            audio_total = st.audio_base + len(st.audio)
            remaining = audio_total - st.win_audio_position
            rel = st.win_audio_position - st.audio_base
            if remaining >= cfg.win_audio:
                win = st.audio[rel:rel + cfg.win_audio]
                last = False
            elif st.finished and remaining >= 512:
                win = st.audio[rel:]
                last = True
            else:
                # trim consumed audio before returning
                if rel > 0:
                    st.audio = st.audio[rel:]
                    st.audio_base = st.win_audio_position
                return
            feats = F.logmel_masked(win, cfg.sample_rate, cfg.feature_dim)
            if not last:
                feats = feats[:-3]
            n_new = feats.shape[0]
            if n_new > 0:
                borrow = cfg.stack_left
                src = np.concatenate([st.log_mel, feats])[-borrow - n_new:]
                stacked = F.stack_frames(src, borrow, 0)[src.shape[0] - n_new:]
                st.log_mel = src[-borrow:] if borrow else src[:0]
                before = st.concat_len
                off = (-before) % cfg.subsample
                st.concat_len = before + n_new
                st.subsampled = np.concatenate([st.subsampled, stacked[off::cfg.subsample]])
            if last:
                st.win_audio_position = audio_total
                st.audio = st.audio[:0]
                st.audio_base = st.win_audio_position
                return
            st.win_audio_position += cfg.audio_step

    def _gather_round(self) -> list:
        """Host-side geometry of the next window round (shape arithmetic,
        independent of decode outputs, so rounds can be gathered ahead):
        ``(slot, window, left_frame, n_eff, abs_start)`` for each stream
        with a ready window; empty when none has one."""
        cfg = self.cfg
        ready = []
        for i, st in enumerate(self.streams):
            self._advance_features(st)
            total = st.sub_base + st.subsampled.shape[0]
            future = total - st.win_feature_position
            if future <= 0 or (not st.finished and future <= cfg.right_len):
                continue
            left_frame = min(cfg.left_len, st.win_feature_position)
            start = st.win_feature_position - left_frame
            end = min(total, start + cfg.window_len)
            right_frame = cfg.right_len if (end < total or not st.finished) else 0
            window = st.subsampled[start - st.sub_base:end - st.sub_base]
            n_eff = window.shape[0] - left_frame - right_frame
            if n_eff <= 0:
                continue
            ready.append((i, window, left_frame, n_eff, st.win_feature_position))
            st.win_feature_position += n_eff
            # trim feature frames older than the next window's left halo
            drop = (st.win_feature_position - cfg.left_len) - st.sub_base
            if drop > 0:
                st.subsampled = st.subsampled[drop:]
                st.sub_base += drop
        return ready

    def _gather_chunk_round(self) -> list:
        """Host-side geometry of the next incremental round: up to
        ``chunk_len`` pending feature rows a stream, plus, once a stream is
        finalized, its ``right_len`` zero flush rows under the canonical
        final window's key clip (the solo session's ``_process_incremental``
        rules).  ``(slot, content rows, n_new, key_limit, valid_start,
        n_valid, abs_start)`` for each stream with rows to feed."""
        from transformer_transducer_tpu_torch.streaming.incremental import _BIG
        cfg = self.cfg
        chunk, lag = cfg.chunk_len, cfg.right_len
        ready = []
        for i, st in enumerate(self.streams):
            self._advance_features(st)
            total = st.sub_base + st.subsampled.shape[0]
            st.shadow_pos, st.shadow_final_start = advance_window_geometry(
                st.shadow_pos, st.shadow_final_start, total, st.finished, cfg)
            if st.finished and not st.flushed and total > 0:
                st.key_limit = (st.shadow_final_start + cfg.window_len
                                if st.shadow_final_start is not None else total + lag)
                st.pending_flush = lag
                st.flushed = True
            n_content = max(0, min(chunk, total - st.fed))
            n_zero = min(chunk - n_content, st.pending_flush) if st.flushed else 0
            n_new = n_content + n_zero
            if n_new == 0:
                continue
            rel = st.fed - st.sub_base
            content = st.subsampled[rel:rel + n_content]
            out_start = st.fed - lag
            valid_start = max(0, -out_start)
            n_valid = max(0, min(n_new - valid_start, total - (out_start + valid_start)))
            ready.append((i, content, n_new, st.key_limit if st.flushed else _BIG,
                          valid_start, n_valid, out_start + valid_start))
            st.fed += n_new
            st.pending_flush -= n_zero
            # fed content rows are never read again
            drop = min(st.fed, total) - st.sub_base
            if drop > 0:
                st.subsampled = st.subsampled[drop:]
                st.sub_base += drop
        return ready

    # ------------------------------------------------------------------
    def _encode_windows(self, rounds):
        """All windows of ``rounds`` in ONE ``encode_banded`` call, each
        zero-padded to ``window_len``; per round its ``(slot, first row,
        n_rows, abs_start)`` segments in the output."""
        cfg = self.cfg
        items = [w for r in rounds for w in r]
        windows = np.zeros((len(items), cfg.window_len, self._d), np.float32)
        for j, (_, window, _, _, _) in enumerate(items):
            windows[j, :window.shape[0]] = window
        enc = self.model.encode_banded(torch.from_numpy(windows).to(self.device),
                                       cfg.left_context, cfg.right_context)
        self.encode_calls += 1
        self.windows += len(items)
        return enc, [[(slot, lf, n, a) for slot, _, lf, n, a in r] for r in rounds]

    def _encode_chunks(self, rounds):
        """The rounds' cached-encoder steps, in order: each advances the
        round's streams by one chunk (the family's batched step over those
        streams' caches); per round its ``(slot, first row, n_rows,
        abs_start)`` segments in the stacked outputs."""
        cfg = self.cfg
        items = [c for r in rounds for c in r]
        x = np.zeros((len(items), cfg.chunk_len, self._d), np.float32)
        for j, (_, content, _, _, _, _, _) in enumerate(items):
            x[j, :content.shape[0]] = content
        x = torch.from_numpy(x).to(self.device)
        ints = torch.from_numpy(np.array([[c[0], c[2], c[3]] for c in items],
                                         np.int64).T.copy()).to(self.device)
        outs, base = [], 0
        for r in rounds:
            ids, n_new, key_limit = ints[:, base:base + len(r)]
            cache = {"bufs": self._cache["bufs"][ids], "n_in": self._cache["n_in"][ids]}
            cache, out, _ = self._inc_step(self._layers, cache, x[base:base + len(r)],
                                           n_new, key_limit)
            self._cache["bufs"][ids] = cache["bufs"]
            self._cache["n_in"][ids] = cache["n_in"]
            outs.append(out)
            base += len(r)
        self.encode_calls += len(rounds)
        self.windows += len(items)
        return (torch.cat(outs),
                [[(slot, vs, nv, a) for slot, _, _, _, vs, nv, a in r] for r in rounds])

    def _run_rounds(self, rounds) -> List[List[int]]:
        """Encode ``rounds`` (one encoder call for the windows of all of
        them, or their chunks' steps in order), then decode them round by
        round; the new tokens a slot."""
        enc, segs = (self._encode_chunks if self.incremental else self._encode_windows)(rounds)
        flat = [(j, first, n) for j, (_, first, n, _) in enumerate(s for r in segs for s in r)]
        rows_at = enc.shape[1]
        idx = np.concatenate([j * rows_at + first + np.arange(n) for j, first, n in flat])
        rows = enc.reshape(-1, enc.shape[-1])[torch.from_numpy(idx).to(self.device)]
        out: List[List[int]] = [[] for _ in range(self.n)]
        base = 0
        for r in segs:
            n_rows = sum(n for _, _, n, _ in r)
            new = self._decode_round(rows[base:base + n_rows],
                                     [(slot, n, a) for slot, _, n, a in r])
            for slot, toks in enumerate(new):
                out[slot] += toks
            base += n_rows
        return out

    @torch.no_grad()
    def process(self) -> List[List[int]]:
        """One serving round over the streams with work; returns the new
        tokens a stream.  Call repeatedly until it returns all-empty."""
        ready = (self._gather_chunk_round if self.incremental else self._gather_round)()
        if not ready:
            return [[] for _ in range(self.n)]
        return self._run_rounds([ready])

    # ------------------------------------------------------------------
    # Continuous batching: a slot whose stream has drained is reset and
    # given the next caller while the other streams keep decoding, so one
    # long utterance never holds the batch back.
    # ------------------------------------------------------------------
    def stream_done(self, i: int) -> bool:
        """True when stream ``i`` is finalized and fully drained (no
        feature rows or flush rows left to decode): the slot can be
        ``reset_streams([i])`` and given a new caller."""
        st = self.streams[i]
        if not st.finished:
            return False
        self._advance_features(st)
        total = st.sub_base + st.subsampled.shape[0]
        if self.incremental:
            if not st.flushed:
                return total == 0       # finalized with no decodable audio
            return st.fed >= total and st.pending_flush <= 0
        return st.win_feature_position >= total

    @torch.no_grad()
    def reset_streams(self, slots: List[int]) -> None:
        """Reset the given slots to fresh streams in one masked update of
        the rings, counts and caches, leaving every other stream's host and
        device state untouched (their label projections are not
        recomputed: a stream's label state is a function of its ring)."""
        if not slots:
            return
        slots = sorted(set(slots))
        for i in slots:
            self.streams[i] = _StreamState(self.cfg, self._d)
        ids = torch.tensor(slots, device=self.device)
        fresh = torch.zeros_like(self._buf[0])
        fresh[0] = self.cfg.seed_token
        self._buf[ids] = fresh
        self._count[slots] = 1
        self._blank_run[slots] = 0
        self._emitted_any[slots] = False
        self._dec_proj[ids] = self._label_proj(ids, torch.ones_like(ids))
        if self.incremental:
            self._cache["bufs"][ids] = 0.0
            self._cache["n_in"][ids] = 0

    def serve_files(self, waves: List[np.ndarray], max_rounds: int = 100000,
                    rounds_per_call: int = 4) -> List[List[int]]:
        """Continuous-batching file server: decode ``len(waves)`` utterances
        through ``n_streams`` slots, admitting the next utterance into a
        slot the moment its stream drains (per-slot turnover; in the
        gang-scheduled group mode the whole batch waits for its longest
        member).  Returns per-utterance tokens in input order; timestamps,
        confidences and segments land in ``self.last_meta`` (same order),
        serving stats (rounds, slot utilization, per-utterance wall-clock
        latency from admission to drain) in ``self.last_stats``.

        ``rounds_per_call`` rounds run as one drain group between admission
        checks (the same tokens as round by round): a drained slot idles up
        to ``rounds_per_call - 1`` rounds before turnover, and
        ``slot_utilization`` is an upper bound at that granularity (exact
        at 1)."""
        self.reset()
        pending = list(range(len(waves)))
        active = {}                      # slot -> utterance index
        results: List[Optional[List[int]]] = [None] * len(waves)
        self.last_meta = [None] * len(waves)
        admit_t = [None] * len(waves)    # host wall clock at admission
        latency_s = [None] * len(waves)  # admission -> drained

        def admit(slot):
            k = pending.pop(0)
            active[slot] = k
            admit_t[k] = time.perf_counter()
            self.accept_waveform(slot, waves[k])
            self.finalize(slot)

        for slot in range(self.n):
            if pending:
                admit(slot)
            else:
                self.finalize(slot)      # empty slot: a finished no-op stream
        rounds = 0
        occupied_slot_rounds = 0
        while active and rounds < max_rounds:
            n_run = self._drain_rounds(min(rounds_per_call, max_rounds - rounds))
            rounds += n_run
            occupied_slot_rounds += len(active) * n_run
            freed = [s for s in active if self.stream_done(s)]
            if n_run == 0 and not freed:
                raise RuntimeError("serve_files stalled: active streams have no "
                                   "decodable work and none drained")
            for slot in freed:
                k = active.pop(slot)
                latency_s[k] = time.perf_counter() - admit_t[k]
                st = self.streams[slot]
                results[k] = list(st.result)
                self.last_meta[k] = {"timestamps": list(st.timestamps),
                                     "confidences": list(st.confidences),
                                     "segments": [list(s) for s in st.segments if s]}
            if freed:
                self.reset_streams(freed)
                for slot in freed:
                    if pending:
                        admit(slot)
                    else:
                        self.finalize(slot)
        self.last_stats = {
            "rounds": rounds,
            # the share of slot-rounds that carried a live utterance
            "slot_utilization": (occupied_slot_rounds / (rounds * self.n)
                                 if rounds else 0.0),
            "utt_latency_s": latency_s,
        }
        if active:
            raise RuntimeError(f"serve_files exceeded {max_rounds} rounds with "
                               f"{len(active)} streams undrained")
        return results

    def run_to_completion(self, max_rounds: int = 10000) -> List[List[int]]:
        """Drain all streams (all must be finalized first), ``MAX_ROUNDS``
        rounds a group: the same tokens as round-by-round ``process()``."""
        if not all(st.finished for st in self.streams):
            raise ValueError("finalize() every stream before run_to_completion()")
        self._drain_rounds(max_rounds)
        return [st.result for st in self.streams]

    @torch.no_grad()
    def _drain_rounds(self, max_rounds: int) -> int:
        """Run up to ``max_rounds`` rounds in groups of up to
        ``MAX_ROUNDS``; returns the number run (0 when no stream has
        decodable work left)."""
        gather = self._gather_chunk_round if self.incremental else self._gather_round
        budget = max_rounds
        while budget > 0:
            # gather at most one group of rounds before decoding it, so host
            # memory stays O(group x N windows), not O(total audio)
            group = []
            while len(group) < min(self.MAX_ROUNDS, budget):
                ready = gather()
                if not ready:
                    break
                group.append(ready)
            if not group:
                break
            budget -= len(group)
            self._run_rounds(group)
            if len(group) < self.MAX_ROUNDS:
                break
        return max_rounds - budget
