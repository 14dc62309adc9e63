"""Build and load the port's hand-written CUDA kernels.

The sources under ``transformer_transducer_tpu_torch/csrc/`` (``*.cu``, and
the ``*.cuh`` headers they include) have a plain C interface.  At first use
they are compiled with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/``
at the root of the checkout, one ``nvcc`` process a source, all started
together, then linked into one library under a name keyed by a hash of the
sources, headers and flags, so an unchanged tree does not rebuild, and
loaded with ``ctypes``.  Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[2]
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libttx_torch_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for this exact tree exists."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # compile each source in its own process, all at once, into a private
    # directory, then link and rename: a concurrent process never loads a
    # half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [proc.communicate() for proc in procs]
        failed = [(src.name, proc.returncode, err) for src, proc, (_, err)
                  in zip(SOURCES, procs, logs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({code}):\n{err}" for name, code, err in failed))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                               "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({proc.returncode}):\n{proc.stderr}")
        (BUILD_DIR / (path.stem + ".ptxas.txt")).write_text(
            "".join(err for _, err in logs))
        os.replace(lib, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        # q, k, v, their row strides, the three tables
        inputs = [ptr, ptr, ptr, i64, i64, i64, ptr, ptr, ptr]
        signatures = {
            # ... out, lse, B, T, H, Dh, [left, right,] stream
            "ttx_banded_attention_fwd": inputs + [ptr, ptr] + [i32] * 6 + [ptr],
            "ttx_flash_rel_attention_fwd": inputs + [ptr, ptr] + [i32] * 4 + [ptr],
            # ... out, lse, sums, B, T, H, Dh, stream
            "ttx_flash_rel_attention_fwd_bf16": inputs + [ptr] * 3 + [i32] * 4 + [ptr],
            # ... out, lse, dout, dq, dk, dv, dre, du, drb, [part,] B, T, H,
            # Dh, [left, right,] stream
            "ttx_banded_attention_bwd": inputs + [ptr] * 10 + [i32] * 6 + [ptr],
            "ttx_flash_rel_attention_bwd": inputs + [ptr] * 9 + [i32] * 4 + [ptr],
            # ... sums, lse, grad, dq, dk, dv, dre, du, drb, work, B, T, H, Dh,
            # stream ([stages,] first for the parts alone)
            "ttx_flash_rel_attention_bwd_bf16": inputs + [ptr] * 10 + [i32] * 4 + [ptr],
            "ttx_flash_rel_attention_bwd_bf16_stages":
                [i32] + inputs + [ptr] * 10 + [i32] * 4 + [ptr],
            # sb, sl, alpha, B, D, U1, stream
            "ttx_rnnt_alpha": [ptr, ptr, ptr, i32, i32, i32, ptr],
            # sb, sl, inject, beta, B, D, U1, stream
            "ttx_rnnt_beta": [ptr, ptr, ptr, ptr, i32, i32, i32, ptr],
            # U1, beta, out (K, warps, diagonals a stage, shared bytes)
            "ttx_rnnt_plan": [i32, i32, ctypes.POINTER(i32)],
            # (x0, c, y), out, steps, stream
            "ttx_rnnt_lae_chain": [ptr, ptr, i32, ptr],
            # count of mismatches (uint64), stream
            "ttx_rnnt_log1p_check": [ptr, ptr],
            # A, L, logZ, workspace, B, T, U1, V, stream
            "ttx_additive_logz": [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr],
            # lp_b, lp_l, d, alpha, work, B, T, S, chunks, stream
            "ttx_band_alpha": [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr],
            # lp_b, lp_l, d, tf, sf, beta, work, B, T, S, chunks, stream
            "ttx_band_beta": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr],
            # dims, cap
            "ttx_attention_head_dims": [ctypes.POINTER(i32), i32],
            "ttx_rnnt_max_u1": [],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i32
        # B, T, H, Dh, left, right -> floats of the banded backward's scratch
        lib.ttx_banded_attention_bwd_scratch.argtypes = [i32] * 6
        lib.ttx_banded_attention_bwd_scratch.restype = i64
        # B, T, U1, V, info -> words of the logZ's workspace
        lib.ttx_additive_logz_workspace.argtypes = [i32] * 4 + [ctypes.POINTER(i64)]
        lib.ttx_additive_logz_workspace.restype = i64
        # B, T, H, Dh -> floats of the bf16 flash backward's work buffer
        lib.ttx_flash_rel_attention_bwd_bf16_workspace.argtypes = [i32] * 4
        lib.ttx_flash_rel_attention_bwd_bf16_workspace.restype = i64
        # Dh, out (shared bytes, blocks a multiprocessor, registers)
        for name in ("ttx_flash_rel_attention_fwd_bf16_info",
                     "ttx_flash_rel_attention_bwd_bf16_info"):
            getattr(lib, name).argtypes = [i32, ctypes.POINTER(i32)]
            getattr(lib, name).restype = i32
        lib.ttx_error_string.argtypes = [i32]
        lib.ttx_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def head_dims() -> tuple:
    """The head widths the attention kernels are built for."""
    lib = library()
    dims = (ctypes.c_int * 8)()
    return tuple(dims[:lib.ttx_attention_head_dims(dims, len(dims))])


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library().ttx_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
