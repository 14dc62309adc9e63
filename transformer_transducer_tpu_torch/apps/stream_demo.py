#!/usr/bin/env python3
"""Streaming recognition demo on the card (port of the root
``apps/stream_demo.py``; reference ``audio/streamRec_unlimit_dynamic_window.py``
and ``test.py``).

A wav file is fed to a streaming session in chunks of ``--chunk-ms``
(paced at real time with ``--realtime``), and tokens print as they decode.
``--mic`` reads the microphone instead (needs ``pyaudio``, imported only
then).

    python -m transformer_transducer_tpu_torch.apps.stream_demo \\
        --config configs/joint_streaming.yaml \\
        --checkpoint egs/<name>/<save_model>/epoch_19 --wav audio.wav \\
        [--chunk-ms 100] [--rtf] [--timestamps] [--incremental] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_session(args):
    from transformer_transducer_tpu_torch.models.factory import load_family
    from transformer_transducer_tpu_torch.streaming.session import (
        StreamingConfig, StreamingSession)
    from transformer_transducer_tpu_torch.utils.config import (
        apply_overrides, load_config, stack_context)
    from transformer_transducer_tpu_torch.utils.device import resolve_device
    from transformer_transducer_tpu_torch.utils.vocab import Vocabulary

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    apply_overrides(cfg, args.overrides)
    vocab = Vocabulary.from_file(cfg.data.vocab)
    d_in = (cfg.data.feature_dim or 128) * (1 + sum(stack_context(cfg.data)))
    model = load_family(cfg, d_in, args.checkpoint, device=device)
    scfg = StreamingConfig.from_config(cfg)

    def on_token(tok, _is_split):
        print(vocab.index2word.get(tok, "?"), end="", flush=True)

    session = StreamingSession(model, scfg, on_token=on_token,
                               incremental=args.incremental, device=device)
    return session, vocab


def stream_file(session, path, chunk_ms=100, realtime=False, report_rtf=False):
    from transformer_transducer_tpu_torch.data.wav import read_wave
    wave, rate = read_wave(path)
    chunk = int(rate * chunk_ms / 1000)
    compute = 0.0
    for i in range(0, len(wave), chunk):
        c0 = time.perf_counter()
        session.accept_waveform(wave[i:i + chunk])
        compute += time.perf_counter() - c0
        if realtime:
            time.sleep(max(0.0, chunk_ms / 1000 - (time.perf_counter() - c0)))
    c0 = time.perf_counter()
    session.finalize()
    compute += time.perf_counter() - c0
    print()
    if report_rtf:
        audio_s = len(wave) / rate
        print(f"audio {audio_s:.2f}s, compute {compute:.2f}s, "
              f"RTF {compute / audio_s:.4f} ({audio_s / compute:.1f}x realtime)")
    return session.result


def stream_mic(session, seconds=15, rate=16000):  # pragma: no cover
    try:
        import pyaudio
    except ImportError:
        sys.exit("pyaudio is not installed; use --wav file streaming instead")
    pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=1, rate=rate,
                     frames_per_buffer=1024, input=True)
    print("recording... speak now")
    end = time.time() + seconds
    while time.time() < end:
        data = np.frombuffer(stream.read(1024), dtype=np.int16)
        session.accept_waveform(data)
    stream.stop_stream()
    stream.close()
    pa.terminate()
    session.finalize()
    print()
    return session.result


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="a port checkpoint directory written by the trainer "
                         "(epoch_N), its model.pt, or a flat state_dict file "
                         "written with torch.save; random weights without it")
    ap.add_argument("--wav", default=None)
    ap.add_argument("--mic", action="store_true")
    ap.add_argument("--seconds", type=int, default=15)
    ap.add_argument("--chunk-ms", type=int, default=100)
    ap.add_argument("--realtime", action="store_true",
                    help="pace file chunks at real time")
    ap.add_argument("--rtf", action="store_true", help="report RTF")
    ap.add_argument("--int8", action="store_true",
                    help="W8A8 int8 serving (post-training quantization)")
    ap.add_argument("--incremental", action="store_true",
                    help="cached-encoder session: work in the new frames a "
                         "step instead of re-encoding the halo")
    ap.add_argument("--timestamps", action="store_true",
                    help="print each token's emission time in seconds and "
                         "its softmax confidence")
    ap.add_argument("--gui", action="store_true",
                    help="Tk window (requires a display)")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="KEY=VALUE", help="config override (dotted key)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; pass cpu to run there)")
    args = ap.parse_args(argv)
    if args.int8:
        raise NotImplementedError("int8 serving (ops/quant.py) is ported in a "
                                  "later slice of the PyTorch port")
    if args.gui:
        raise NotImplementedError("the Tk window (apps/gui.py) is ported in a "
                                  "later slice of the PyTorch port")
    if not (args.mic or args.wav):
        sys.exit("need --wav or --mic")

    session, vocab = build_session(args)
    if args.mic:
        result = stream_mic(session, args.seconds)
    else:
        result = stream_file(session, args.wav, args.chunk_ms, args.realtime,
                             args.rtf)
    text = "".join(vocab.decode(result))
    print("final:", text)
    print("segments:", [len(s) for s in session.segments])
    if args.timestamps:
        # subsampled-frame period = subsample x 10 ms mel hop
        period = session.cfg.subsample * 0.01
        for tok, frame, conf in zip(result, session.timestamps,
                                    session.confidences):
            word = vocab.index2word.get(tok, "?")
            print(f"  {frame * period:7.2f}s  p={np.exp(conf):.3f}  {word}")
    return text


if __name__ == "__main__":
    main()
