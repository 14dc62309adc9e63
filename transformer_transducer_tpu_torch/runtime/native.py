"""ctypes loader of the port's C++ runtime (port of ``runtime/native.py``).

The library (``transformer_transducer_tpu_torch/csrc/ttx_runtime.cc``)
speeds up host-side loops of the data and evaluation pipeline: the edit
distance behind the CER, WAV decoding, and a frame-parallel log-mel
featurizer.  At first use it is compiled with ``g++ -O3 -std=c++17 -fPIC
-Wall -pthread -shared`` (``$CXX`` if set, as the repo-root ``csrc/Makefile``
reads it; ``-pthread`` where the Makefile has ``-fopenmp``: the featurizer
splits its frames between ``std::thread``s, ``OMP_NUM_THREADS`` of them if
set, else one a core, since the card's machine has a g++ without libgomp)
into ``build/ttx_runtime/`` at the root of the checkout, under a
name keyed by a hash of the source, the compiler's version and the flags; the library
is written to a private directory and renamed into place, so processes that
build at once never load a half-written file.  Nothing is built when the
module is imported.  ``TTX_RUNTIME_LIB``, when it names an existing file,
is loaded in place of the build, as in the JAX package.

A failure is not hidden.  Where a compiler is found and the build or the
load fails, :func:`library_or_none` raises with the compiler's output.  Only
where no C++ compiler exists and ``TTX_RUNTIME_LIB`` names no library does
it return None, and the callers (``utils/metrics.py``,
``ops/features_np.py``) run their numpy paths; the log says so once.

Each call into the library adds one to its count in :data:`CALLS`
(``levenshtein``, ``batch_levenshtein``, ``logmel``), as the kernel
wrappers count their launches, so a caller can tell which route was taken.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "ttx_runtime.cc"
BUILD_DIR = _PKG.parent / "build" / "ttx_runtime"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

CALLS = {"levenshtein": 0, "batch_levenshtein": 0, "logmel": 0}
_lock = threading.Lock()
_loaded: Optional["_Native"] = None
_said_numpy = False


def _count(name: str) -> None:
    with _lock:
        CALLS[name] += 1


def reset_calls() -> None:
    with _lock:
        for name in CALLS:
            CALLS[name] = 0


def read_calls() -> dict:
    with _lock:
        return dict(CALLS)


def compiler() -> Optional[str]:
    """The C++ compiler's path (``$CXX``, else ``g++``), or None."""
    return shutil.which(os.environ.get("CXX") or "g++")


def library_path(cxx: str) -> Path:
    """The library's path, keyed by the source, the flags and the
    compiler's version (a checkout copied to another machine rebuilds)."""
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    digest = hashlib.sha256("\n".join([version, *CXX_FLAGS]).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libttx_runtime_{digest.hexdigest()[:16]}.so"


def build(cxx: Optional[str] = None) -> Path:
    """Compile the library unless one for this source, compiler and flags
    exists; raises with the compiler's output if it fails."""
    cxx = cxx or compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found ($CXX or g++) to build "
                           f"{SOURCE.name}")
    path = library_path(cxx)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", out, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0 or not os.path.exists(out):
            raise RuntimeError(f"{cxx} failed to build {SOURCE} "
                               f"({proc.returncode}):\n{proc.stderr}{proc.stdout}")
        os.replace(out, path)
    return path


class _Native:
    """The library's four entry points with the JAX package's contracts."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i16p = ctypes.POINTER(ctypes.c_int16)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ttx_levenshtein.restype = ctypes.c_int64
        lib.ttx_levenshtein.argtypes = [i32p, ctypes.c_int64, i32p, ctypes.c_int64]
        lib.ttx_batch_levenshtein.restype = ctypes.c_int64
        lib.ttx_batch_levenshtein.argtypes = [i32p, i64p, i32p, i64p, ctypes.c_int64, i64p]
        lib.ttx_parse_wav.restype = ctypes.c_int64
        lib.ttx_parse_wav.argtypes = [u8p, ctypes.c_int64, i16p, ctypes.c_int64, i32p]
        lib.ttx_logmel.restype = ctypes.c_int64
        lib.ttx_logmel.argtypes = [i16p, ctypes.c_int64, f32p, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                   f32p, ctypes.c_int64]

    def levenshtein(self, a, b) -> int:
        """Edit distance between two integer sequences."""
        a = np.ascontiguousarray(a, dtype=np.int32)
        b = np.ascontiguousarray(b, dtype=np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        dist = self._lib.ttx_levenshtein(a.ctypes.data_as(i32p), len(a),
                                         b.ctypes.data_as(i32p), len(b))
        _count("levenshtein")
        return int(dist)

    def batch_levenshtein(self, preds, refs):
        """Lists of integer sequences -> ``(total distance, total length of
        refs)``, one call for the whole batch."""
        if len(preds) != len(refs):
            raise ValueError(f"{len(preds)} predictions against {len(refs)} references")

        def pack(seqs):
            flat = np.concatenate([np.asarray(s, np.int32) for s in seqs]
                                  or [np.zeros(0, np.int32)]).astype(np.int32)
            off = np.zeros(len(seqs) + 1, np.int64)
            np.cumsum([len(s) for s in seqs], out=off[1:])
            return np.ascontiguousarray(flat), off

        pf, po = pack(preds)
        rf, ro = pack(refs)
        total = ctypes.c_int64(0)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        dist = self._lib.ttx_batch_levenshtein(
            pf.ctypes.data_as(i32p), po.ctypes.data_as(i64p),
            rf.ctypes.data_as(i32p), ro.ctypes.data_as(i64p),
            len(preds), ctypes.byref(total))
        _count("batch_levenshtein")
        return int(dist), int(total.value)

    def logmel(self, wav: np.ndarray, mel: np.ndarray, n_fft: int = 512,
               hop: int = 160, variant: str = "masked"):
        """int16 wave + ``(n_mels, n_fft // 2 + 1)`` float32 filterbank ->
        ``(frames, n_mels)`` float32 log-mel, frame-parallel in C++ without
        the interpreter lock; ``variant`` 'masked' (ln, non-positive bins 0)
        or 'eps' (log10, zeros floored to float64 eps).  None where the C
        function refuses the arguments (a wave of ``n_fft // 2`` samples or
        fewer, or ``n_fft`` not a power of two)."""
        if variant not in ("masked", "eps"):
            raise ValueError(f"variant {variant!r}: 'masked' or 'eps'")
        wav = np.ascontiguousarray(wav, dtype=np.int16)
        mel = np.ascontiguousarray(mel, dtype=np.float32)
        n_mels = mel.shape[0]
        if mel.shape[1] != n_fft // 2 + 1:
            raise ValueError(f"filterbank of {mel.shape[1]} bins for n_fft {n_fft}")
        out = np.empty((1 + len(wav) // hop, n_mels), dtype=np.float32)
        i16p = ctypes.POINTER(ctypes.c_int16)
        f32p = ctypes.POINTER(ctypes.c_float)
        n = self._lib.ttx_logmel(wav.ctypes.data_as(i16p), len(wav),
                                 mel.ctypes.data_as(f32p), n_mels, n_fft, hop,
                                 0 if variant == "masked" else 1,
                                 out.ctypes.data_as(f32p), out.size)
        if n < 0:
            return None
        _count("logmel")
        return out[:n]

    def parse_wav(self, raw: bytes):
        """RIFF/PCM16 bytes -> ``(int16 mono samples, rate)`` (the first
        channel), or None on a malformed header."""
        buf = np.frombuffer(raw, dtype=np.uint8)
        out = np.empty(len(raw) // 2, dtype=np.int16)
        rate = ctypes.c_int32(0)
        n = self._lib.ttx_parse_wav(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(out),
            ctypes.byref(rate))
        if n < 0:
            return None
        return out[:n].copy(), int(rate.value)


def library_or_none() -> Optional[_Native]:
    """The loaded library: ``TTX_RUNTIME_LIB`` if it names a file, else the
    build (made at the first call).  None only where no C++ compiler exists
    and no such file is named; a failed build or load raises."""
    global _loaded, _said_numpy
    with _lock:
        if _loaded is not None:
            return _loaded
        env = os.environ.get("TTX_RUNTIME_LIB")
        if env and os.path.exists(env):
            path = env
        else:
            cxx = compiler()
            if cxx is None:
                if not _said_numpy:
                    _said_numpy = True
                    logging.getLogger(__name__).warning(
                        "no C++ compiler ($CXX or g++): the native runtime is not "
                        "built and the CER and log-mel run their numpy paths")
                return None
            path = str(build(cxx))
        try:
            _loaded = _Native(ctypes.CDLL(path))
        except (OSError, AttributeError) as e:
            raise RuntimeError(f"cannot load the native runtime {path}: {e}") from e
        return _loaded


def library() -> _Native:
    """The loaded library; raises where :func:`library_or_none` gives None."""
    lib = library_or_none()
    if lib is None:
        raise RuntimeError("the native runtime needs a C++ compiler ($CXX or g++) "
                           "or TTX_RUNTIME_LIB naming a built library")
    return lib
