"""Build and load the port's hand-written CUDA kernels.

The sources under ``transformer_transducer_tpu_torch/csrc/`` have a plain C
interface.  At first use they are compiled with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/`` at the root of the checkout, under a name keyed by
a hash of the sources and flags, so an unchanged tree does not rebuild, and
loaded with ``ctypes``.  Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[2]
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libttx_torch_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for this exact tree exists."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                           *map(str, SOURCES)], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    (BUILD_DIR / (path.stem + ".ptxas.txt")).write_text(proc.stderr)
    os.replace(tmp, path)
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
            # ... out, lse, B, T, H, [left, right,] stream
            "ttx_banded_attention_fwd": inputs + [ptr, ptr] + [i32] * 5 + [ptr],
            "ttx_flash_rel_attention_fwd": inputs + [ptr, ptr] + [i32] * 3 + [ptr],
            # ... out, lse, dout, dq, dk, dv, dre, du, drb, B, T, H,
            # [left, right,] stream
            "ttx_banded_attention_bwd": inputs + [ptr] * 9 + [i32] * 5 + [ptr],
            "ttx_flash_rel_attention_bwd": inputs + [ptr] * 9 + [i32] * 3 + [ptr],
            # sb, sl, alpha, B, D, U1, stream
            "ttx_rnnt_alpha": [ptr, ptr, ptr, i32, i32, i32, ptr],
            # sb, sl, inject, beta, B, D, U1, stream
            "ttx_rnnt_beta": [ptr, ptr, ptr, ptr, i32, i32, i32, ptr],
            "ttx_head_dim": [],
            "ttx_rnnt_max_u1": [],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i32
        lib.ttx_error_string.argtypes = [i32]
        lib.ttx_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library().ttx_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
