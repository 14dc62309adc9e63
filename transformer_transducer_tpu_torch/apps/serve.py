#!/usr/bin/env python3
"""Batch-serving CLI on the card: decode many wav files as concurrent
streams (port of the root ``apps/serve.py``).

N files ride one ``BatchedStreamingSession``: each serving round encodes
the ready windows of all streams in one ``encode_banded`` call (or
advances their cached encoders, ``--incremental``) and decodes them
together; a drain encodes up to 16 rounds' windows a call.  Each file's
output equals a solo ``StreamingSession`` fed the same audio.

    python -m transformer_transducer_tpu_torch.apps.serve \\
        --config configs/joint_streaming.yaml \\
        --checkpoint egs/<name>/<save_model>/epoch_N --wavs a.wav b.wav c.wav \\
        [--streams 8] [--rtf] [--json] [--latency | --continuous] [--int8] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _file_record(vocab, tokens, timestamps, confidences, segments, period) -> dict:
    return {"text": "".join(vocab.decode(tokens)),
            "tokens": tokens,
            "times_s": [round(f * period, 3) for f in timestamps],
            "confidences": [round(float(np.exp(c)), 6) for c in confidences],
            "segments": ["".join(vocab.decode(seg)) for seg in segments if seg]}


def _percentiles(values, digits: int) -> dict:
    arr = np.asarray(values, np.float64)
    return {"mean": round(float(arr.mean()), digits),
            **{f"p{q}": round(float(np.percentile(arr, q)), digits) for q in (50, 95, 99)}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True,
                    help="a checkpoint directory written by the port's trainer "
                         "(epoch_N), its model.pt, a flat state_dict file "
                         "written with torch.save, or a JAX package checkpoint "
                         "directory (msgpack)")
    ap.add_argument("--wavs", nargs="+", required=True)
    ap.add_argument("--streams", type=int, default=None,
                    help="concurrent streams per round (default: min(len(wavs), 8))")
    ap.add_argument("--int8", action="store_true",
                    help="W8A8 int8 serving (post-training quantization)")
    ap.add_argument("--incremental", action="store_true",
                    help="cached-encoder rounds: encoder work in the new frames "
                         "and short greedy scans")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: admit the next queued file into a "
                         "slot the moment its stream drains, instead of "
                         "gang-scheduling fixed groups; ends with a JSON summary "
                         "of slot utilization and per-utterance latency")
    ap.add_argument("--rtf", action="store_true", help="report aggregate x-realtime")
    ap.add_argument("--json", action="store_true",
                    help="one JSON line per file: text, tokens, per-token emission "
                         "times (s) and softmax confidences, sentence segments")
    ap.add_argument("--latency", action="store_true",
                    help="drain round by round (one process() a round) and end "
                         "with a JSON summary of round latency p50/p95/p99 and "
                         "each file's first-token latency")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="KEY=VALUE", help="config override (dotted key)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; pass cpu to run there)")
    args = ap.parse_args(argv)

    from transformer_transducer_tpu_torch.data.wav import read_wave
    from transformer_transducer_tpu_torch.models.factory import load_family
    from transformer_transducer_tpu_torch.streaming.batched import BatchedStreamingSession
    from transformer_transducer_tpu_torch.streaming.session import StreamingConfig
    from transformer_transducer_tpu_torch.utils.config import (
        apply_overrides, load_config, stack_context)
    from transformer_transducer_tpu_torch.utils.device import resolve_device
    from transformer_transducer_tpu_torch.utils.vocab import Vocabulary

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    apply_overrides(cfg, args.overrides)
    scfg = StreamingConfig.from_config(cfg)
    vocab = Vocabulary.from_file(cfg.data.vocab)
    d_in = (cfg.data.feature_dim or 128) * (1 + sum(stack_context(cfg.data)))
    model = load_family(cfg, d_in, args.checkpoint, device=device, int8=args.int8)
    n_streams = args.streams or min(len(args.wavs), 8)
    session = BatchedStreamingSession(model, scfg, n_streams,
                                      incremental=args.incremental, device=device)
    period = scfg.subsample * 0.01       # subsampled-frame period, seconds

    def emit(results):
        for path in args.wavs:
            rec = results[path]
            if args.json:
                print(json.dumps({"file": path, **rec}, ensure_ascii=False))
            else:
                print(f"{path}\t{rec['text']}")

    results = {}
    total_audio_s = 0.0
    round_lats = []          # --latency: wall ms of each process() round
    first_token_ms = {}      # --latency: path -> first-token latency, ms
    t0 = time.perf_counter()

    if args.continuous:
        waves = []
        for path in args.wavs:
            wave, rate = read_wave(path)
            total_audio_s += len(wave) / rate
            waves.append(wave)
        tokens_all = session.serve_files(waves)
        wall = time.perf_counter() - t0
        for k, path in enumerate(args.wavs):
            meta = session.last_meta[k]
            rec = _file_record(vocab, tokens_all[k], meta["timestamps"],
                               meta["confidences"], meta["segments"], period)
            results[path] = rec if args.json else {"text": rec["text"]}
        emit(results)
        stats = session.last_stats
        print(json.dumps({"summary": {
            "mode": "continuous",
            "slots": n_streams,
            "files": len(args.wavs),
            "rounds": stats["rounds"],
            "slot_utilization": round(stats["slot_utilization"], 4),
            "aggregate_x_realtime": round(total_audio_s / wall, 2),
            "utt_latency_s": _percentiles(stats["utt_latency_s"], 3),
        }}, ensure_ascii=False))
        if args.rtf:
            print(f"# aggregate: {total_audio_s:.1f}s audio in {wall:.2f}s "
                  f"= {total_audio_s / wall:.1f}x realtime "
                  f"({n_streams} slots, continuous)", file=sys.stderr)
        return

    # gang scheduling: groups of up to n_streams files
    for base in range(0, len(args.wavs), n_streams):
        group = args.wavs[base:base + n_streams]
        if base > 0:
            session.reset()
        for slot, path in enumerate(group):
            wave, rate = read_wave(path)
            total_audio_s += len(wave) / rate
            session.accept_waveform(slot, wave)
            session.finalize(slot)
        for slot in range(len(group), n_streams):
            session.finalize(slot)       # empty slots ride along as no-ops
        if args.latency:
            # each process() is one serving round: the live-mode SLO unit
            t_grp = time.perf_counter()
            while True:
                t_r = time.perf_counter()
                new = session.process()
                lat = (time.perf_counter() - t_r) * 1e3
                now_ms = (time.perf_counter() - t_grp) * 1e3
                for slot, path in enumerate(group):
                    if path not in first_token_ms and session.streams[slot].result:
                        first_token_ms[path] = round(now_ms, 2)
                if not any(new):
                    break                # the final empty gather is not a round
                round_lats.append(lat)
            tokens = [list(st.result) for st in session.streams]
        else:
            tokens = session.run_to_completion()
        for slot, path in enumerate(group):
            st = session.streams[slot]
            rec = _file_record(vocab, tokens[slot], st.timestamps, st.confidences,
                               st.segments, period)
            results[path] = rec if args.json else {"text": rec["text"]}
    wall = time.perf_counter() - t0

    emit(results)
    if args.rtf:
        print(f"# aggregate: {total_audio_s:.1f}s audio in {wall:.2f}s "
              f"= {total_audio_s / wall:.1f}x realtime "
              f"({n_streams} streams/round)", file=sys.stderr)
    if args.latency and round_lats:
        print(json.dumps({"summary": {
            "streams_per_round": n_streams,
            "rounds": len(round_lats),
            "aggregate_x_realtime": round(total_audio_s / wall, 2),
            "round_latency_ms": _percentiles(round_lats, 2),
            "first_token_ms": first_token_ms,
        }}, ensure_ascii=False))


if __name__ == "__main__":
    main()
