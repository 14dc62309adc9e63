"""Kaldi ark/scp matrix & vector I/O (port of ``data/kaldiio.py``, numpy
only; malformed input raises ``ValueError``).

Parity surface: the reference vendors kaldi-io (``tt/kaldi_io.py``, 799 LoC)
and uses it for per-speaker CMVN statistics (``tt/dataset.py:26-34,61-69``
via ``read_mat_scp``).  This is a fresh implementation of the Kaldi archive
format from its public spec: binary ('\\0B') float/double matrices ("FM"/"DM")
and vectors ("FV"/"DV"), plus text archives; scp files are ``key path:offset``
lines.  API names mirror the vendored module (``read_mat_scp``:401,
``read_mat``:448, ``write_mat``:558) for drop-in familiarity.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np


def _read_token(fh) -> str:
    chars = []
    while True:
        c = fh.read(1)
        if c == b"" or c == b" ":
            break
        chars.append(c)
    return b"".join(chars).decode()


def _read_int32(fh) -> int:
    size = fh.read(1)
    if size != b"\x04":
        raise ValueError(f"expected int32 size byte, got {size!r}")
    return struct.unpack("<i", fh.read(4))[0]


def _write_int32(fh, value: int) -> None:
    fh.write(b"\x04")
    fh.write(struct.pack("<i", value))


def read_mat(path_or_fh) -> np.ndarray:
    """Read one matrix; accepts ``path``, ``path:offset`` or a file object."""
    if isinstance(path_or_fh, str):
        if ":" in path_or_fh and path_or_fh.rsplit(":", 1)[1].isdigit():
            path, offset = path_or_fh.rsplit(":", 1)
            fh = open(path, "rb")
            fh.seek(int(offset))
        else:
            fh = open(path_or_fh, "rb")
        with fh:
            return _read_mat_stream(fh)
    return _read_mat_stream(path_or_fh)


def _read_mat_stream(fh) -> np.ndarray:
    binary = fh.read(2)
    if binary == b"\x00B":
        token = _read_token(fh)
        if token == "CM":
            return _read_compressed(fh)
        if token in ("CM2", "CM3"):
            raise ValueError(f"kaldi compression format {token!r} "
                             "(per-element uint16/uint8 without column "
                             "headers) is not supported")
        if token in ("FM", "DM"):
            dtype = np.float32 if token == "FM" else np.float64
            rows = _read_int32(fh)
            cols = _read_int32(fh)
            data = np.frombuffer(fh.read(rows * cols * dtype().itemsize), dtype)
            return data.reshape(rows, cols).copy()
        if token in ("FV", "DV"):
            dtype = np.float32 if token == "FV" else np.float64
            n = _read_int32(fh)
            return np.frombuffer(fh.read(n * dtype().itemsize), dtype).copy()
        raise ValueError(f"unsupported kaldi token {token!r}")
    # text matrix: "[ rows... ]"
    rest = (binary + fh.read()).decode()
    if "[" not in rest:
        raise ValueError("not a kaldi matrix")
    body = rest[rest.index("[") + 1:rest.index("]")]
    rows = [r.split() for r in body.strip().splitlines() if r.strip()]
    return np.asarray([[float(v) for v in r] for r in rows], dtype=np.float32)


# ---------------------------------------------------------------------------
# Compressed matrices ('CM ' — Kaldi CompressedMatrix format 1, the format
# real-world `compute-cmvn-stats` / feature archives commonly use; reference
# reader: tt/kaldi_io.py:470-518).  Layout after the 'CM ' token:
#   global header:  min f32, range f32, num_rows i32, num_cols i32
#   per column:     4x uint16 quantized percentiles (p0, p25, p75, p100)
#   data:           num_cols * num_rows uint8, column-major
# A uint16 percentile q dequantizes to  min + range * q / 65535.  A uint8
# value c within a column decodes piecewise-linearly between the percentiles:
#   c <= 64:        p0  + (p25 - p0)   * c / 64
#   64 < c <= 192:  p25 + (p75 - p25)  * (c - 64) / 128
#   c > 192:        p75 + (p100 - p75) * (c - 192) / 63

_CM_GLOBAL = np.dtype([("min", "<f4"), ("range", "<f4"),
                       ("rows", "<i4"), ("cols", "<i4")])


def _read_compressed(fh) -> np.ndarray:
    gmin, grange, rows, cols = np.frombuffer(fh.read(16), _CM_GLOBAL, 1)[0]
    heads = np.frombuffer(fh.read(int(cols) * 8), "<u2").reshape(cols, 4)
    heads = gmin + grange * heads.astype(np.float64) / 65535.0
    data = np.frombuffer(fh.read(int(cols) * int(rows)), np.uint8)
    data = data.reshape(cols, rows).astype(np.float32)
    p0, p25, p75, p100 = (heads[:, i:i + 1].astype(np.float32)
                          for i in range(4))
    lo = p0 + (p25 - p0) * (data / 64.0)
    mid = p25 + (p75 - p25) * ((data - 64.0) / 128.0)
    hi = p75 + (p100 - p75) * ((data - 192.0) / 63.0)
    mat = np.where(data <= 64, lo, np.where(data <= 192, mid, hi))
    return np.ascontiguousarray(mat.T)  # column-major -> row-major


def write_mat_compressed(path_or_fh, mat: np.ndarray, key: str = "") -> int:
    """Write a matrix in the 'CM ' format (lossy: uint8 per element).

    Percentile choice follows Kaldi's CompressedMatrix: per column the
    quantized smallest / rank-``rows/4`` / rank-``3*rows/4`` / largest
    values; elements then encode to the piecewise-linear uint8 code with
    round-to-nearest.  Mainly used to synthesize test fixtures and to
    emit compact feature archives.
    """
    own = isinstance(path_or_fh, str)
    fh = open(path_or_fh, "wb") if own else path_or_fh
    try:
        if key:
            fh.write(key.encode() + b" ")
        offset = fh.tell()
        mat = np.asarray(mat, dtype=np.float32)
        rows, cols = mat.shape
        gmin = float(mat.min())
        grange = float(mat.max()) - gmin or 1.0
        fh.write(b"\x00BCM ")
        fh.write(np.array([(gmin, grange, rows, cols)],
                          dtype=_CM_GLOBAL).tobytes())

        def quantize(v):
            return np.clip(np.floor((v - gmin) / grange * 65535.0),
                           0, 65535).astype("<u2")

        srt = np.sort(mat, axis=0)  # per-column ranks
        q = np.stack([quantize(srt[0]), quantize(srt[rows // 4]),
                      quantize(srt[(3 * rows) // 4]),
                      quantize(srt[-1])])           # (4, cols) uint16
        fh.write(np.ascontiguousarray(q.T).tobytes())

        p = gmin + grange * q.astype(np.float64) / 65535.0  # dequantized
        p0, p25, p75, p100 = (p[i][None, :] for i in range(4))
        codes = np.empty((rows, cols), np.uint8)
        with np.errstate(divide="ignore", invalid="ignore"):
            lo = np.clip((mat - p0) / np.maximum(p25 - p0, 1e-30) * 64.0,
                         0, 64)
            mid = 64.0 + np.clip(
                (mat - p25) / np.maximum(p75 - p25, 1e-30) * 128.0, 0, 128)
            hi = 192.0 + np.clip(
                (mat - p75) / np.maximum(p100 - p75, 1e-30) * 63.0, 0, 63)
        codes = np.where(mat <= p25, lo, np.where(mat <= p75, mid, hi))
        codes = (codes + 0.5).astype(np.uint8)  # round-to-nearest
        fh.write(np.ascontiguousarray(codes.T).tobytes())
        return offset
    finally:
        if own:
            fh.close()


def write_mat(path_or_fh, mat: np.ndarray, key: str = "") -> int:
    """Write one matrix (binary); returns the data offset (for scp files)."""
    own = isinstance(path_or_fh, str)
    fh = open(path_or_fh, "wb") if own else path_or_fh
    try:
        if key:
            fh.write(key.encode() + b" ")
        offset = fh.tell()
        fh.write(b"\x00B")
        mat = np.asarray(mat)
        token = b"DM " if mat.dtype == np.float64 else b"FM "
        mat = mat.astype(np.float64 if token == b"DM " else np.float32)
        fh.write(token)
        _write_int32(fh, mat.shape[0])
        _write_int32(fh, mat.shape[1])
        fh.write(mat.tobytes())
        return offset
    finally:
        if own:
            fh.close()


def read_mat_scp(scp_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (key, matrix) for each scp line (``key path:offset``)."""
    with open(scp_path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            key, rxfile = line.split(None, 1)
            yield key, read_mat(rxfile)


def read_mat_ark(ark_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (key, matrix) from a binary archive of ``key \\0B FM ...``."""
    with open(ark_path, "rb") as fh:
        while True:
            key_chars = []
            while True:
                c = fh.read(1)
                if c in (b"", b" "):
                    break
                key_chars.append(c)
            if not key_chars:
                break
            yield b"".join(key_chars).decode(), _read_mat_stream(fh)


def write_ark_scp(ark_path: str, scp_path: str,
                  mats: Dict[str, np.ndarray]) -> None:
    """Write a binary ark + matching scp."""
    with open(ark_path, "wb") as ark, open(scp_path, "w") as scp:
        for key, mat in mats.items():
            ark.write(key.encode() + b" ")
            offset = ark.tell()
            write_mat(ark, mat)
            scp.write(f"{key} {ark_path}:{offset}\n")


def cmvn_stats(feats: np.ndarray) -> np.ndarray:
    """Kaldi-layout CMVN stats for one speaker: row 0 = [sum..., count],
    row 1 = [sumsq..., 0] (consumed by ``data.dataset.CMVN``)."""
    d = feats.shape[1]
    stats = np.zeros((2, d + 1), dtype=np.float64)
    stats[0, :d] = feats.sum(axis=0)
    stats[0, d] = feats.shape[0]
    stats[1, :d] = (feats ** 2).sum(axis=0)
    return stats
