#!/usr/bin/env python3
"""Record / play utility (port of the root ``apps/record.py``; reference
``audio/record.py``).

``record`` and ``play`` need ``pyaudio`` (imported only there); ``synth``
writes a test wav without audio hardware.

    python -m transformer_transducer_tpu_torch.apps.record synth tone.wav --seconds 3
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from transformer_transducer_tpu_torch.data.wav import read_wave, write_wave


def record(path: str, seconds: int = 15, rate: int = 16000):  # pragma: no cover
    try:
        import pyaudio
    except ImportError:
        sys.exit("pyaudio is not installed; try `synth` mode")
    pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=1, rate=rate,
                     frames_per_buffer=1024, input=True)
    print(f"recording {seconds}s ...")
    frames = []
    end = time.time() + seconds
    while time.time() < end:
        frames.append(np.frombuffer(stream.read(1024), dtype=np.int16))
    stream.stop_stream()
    stream.close()
    pa.terminate()
    write_wave(path, np.concatenate(frames), rate)
    print("saved", path)


def play(path: str):  # pragma: no cover
    try:
        import pyaudio
    except ImportError:
        sys.exit("pyaudio is not installed")
    wave_data, rate = read_wave(path)
    pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=1, rate=rate, output=True)
    stream.write(wave_data.tobytes())
    stream.stop_stream()
    stream.close()
    pa.terminate()


def synth(path: str, seconds: int = 3, rate: int = 16000):
    """A 440 Hz tone in seeded noise."""
    t = np.arange(int(seconds * rate))
    tone = (np.sin(t * 2 * np.pi * 440 / rate) * 8000
            + np.random.RandomState(0).randn(len(t)) * 500)
    write_wave(path, tone.astype(np.int16), rate)
    print("synthesized", path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["record", "play", "synth"])
    ap.add_argument("path")
    ap.add_argument("--seconds", type=int, default=15)
    args = ap.parse_args(argv)
    {"record": lambda: record(args.path, args.seconds),
     "play": lambda: play(args.path),
     "synth": lambda: synth(args.path, args.seconds)}[args.mode]()


if __name__ == "__main__":
    main()
