"""Tk window for the streaming recognizer (port of the root ``apps/gui.py``;
reference: the Tk windows of ``audio/streamRec*.py:282-323``, start and stop
buttons over a growing text box).

Feeds a session from a microphone (``pyaudio``) or a wav file played in real
time.  ``tkinter`` and ``pyaudio`` are imported only when a window or a
microphone is opened, so headless machines import this module freely (and
use ``apps/stream_demo.py`` without ``--gui``).
"""

from __future__ import annotations

import queue
import threading
import time


class StreamGui:
    def __init__(self, session, vocab, title="TT 流式语音识别 / streaming ASR"):
        import tkinter as tk
        import tkinter.font as font
        self.tk = tk
        self.session = session
        self.vocab = vocab
        self.window = tk.Tk()
        self.window.title(title)
        self.window.geometry("600x570")
        self.text = tk.Text(self.window, font=font.Font(size=14), height=20, width=50)
        self.text.place(x=20, y=20, anchor="nw")
        self.start_button = tk.Button(self.window, text="Start", width=9,
                                      command=self.start)
        self.start_button.place(x=100, y=515, anchor="nw")
        self.stop_button = tk.Button(self.window, text="Stop", width=9,
                                     state=tk.DISABLED, command=self.stop)
        self.stop_button.place(x=400, y=515, anchor="nw")
        self._running = False
        self._source = None
        # tokens come from the feed THREAD, but Tk widgets are not
        # thread-safe: they pass through a queue that a Tk `after` timer
        # drains on the main loop
        self._tokens: "queue.Queue" = queue.Queue()
        session.on_token = self._on_token
        self.window.after(50, self._drain_tokens)

    def set_wav_source(self, path: str, chunk_ms: int = 100):
        from transformer_transducer_tpu_torch.data.wav import read_wave
        wave, rate = read_wave(path)
        chunk = int(rate * chunk_ms / 1000)

        def feed():
            for i in range(0, len(wave), chunk):
                if not self._running:
                    break
                self.session.accept_waveform(wave[i:i + chunk])
                time.sleep(chunk_ms / 1000)
            if self._running:
                self.session.finalize()
        self._source = feed

    def set_mic_source(self, rate: int = 16000):  # pragma: no cover
        import numpy as np
        import pyaudio

        def feed():
            pa = pyaudio.PyAudio()
            stream = pa.open(format=pyaudio.paInt16, channels=1, rate=rate,
                             frames_per_buffer=1024, input=True)
            while self._running:
                self.session.accept_waveform(
                    np.frombuffer(stream.read(1024), dtype=np.int16))
            stream.stop_stream()
            stream.close()
            pa.terminate()
            self.session.finalize()
        self._source = feed

    def _on_token(self, tok: int, split: bool):
        # called from the feed thread: only enqueue here
        self._tokens.put((tok, split))

    def _drain_tokens(self):
        # main-loop side: the only place that touches the Text widget
        try:
            while True:
                tok, split = self._tokens.get_nowait()
                if split:
                    self.text.insert("end", "\n")
                self.text.insert("end", self.vocab.index2word.get(tok, "?"))
        except queue.Empty:
            pass
        self.window.after(50, self._drain_tokens)

    def start(self):
        self.text.delete("1.0", self.tk.END)
        self.session.reset()
        self.session.on_token = self._on_token
        self._running = True
        self.start_button.config(state=self.tk.DISABLED)
        self.stop_button.config(state=self.tk.ACTIVE)
        threading.Thread(target=self._source, daemon=True).start()

    def stop(self):
        self._running = False
        self.start_button.config(state=self.tk.ACTIVE)
        self.stop_button.config(state=self.tk.DISABLED)

    def run(self):
        self.window.mainloop()
