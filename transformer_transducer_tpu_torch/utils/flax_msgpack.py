"""A reader of the msgpack that ``flax.serialization`` writes (the restore
half of ``flax.serialization.msgpack_restore``), in pure Python and numpy.

The JAX package saves each checkpoint component with
``flax.serialization.to_bytes``: the state dict (nested maps with string
keys) packed by ``msgpack`` with three extension types
(``flax/serialization.py``, ``_MsgpackExtType``):

* 1, an ndarray: its payload is itself msgpack, ``(shape, dtype name,
  C-order bytes)``;
* 2, a Python complex: ``(real, imag)``;
* 3, a numpy scalar: an ndarray payload of shape ``()``.

Leaves over 2**30 bytes are split into ``{"__msgpack_chunked_array__":
True, "shape": {...}, "chunks": {...}}`` and joined back here.  numpy has
no bfloat16, so a bfloat16 leaf is read as uint16 and returned as a
``torch.bfloat16`` tensor.  The port reads checkpoints with no ``msgpack``
or ``flax`` package: the card's machine has neither.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

# fixed-width forms: type byte -> (struct format, size)
_FIXED = {
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
    0xCA: (">f", 4), 0xCB: (">d", 8),
}
# sized forms: type byte -> (kind, bytes of the length field)
_SIZED = {
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
    0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    """One msgpack document over a buffer; ``base`` is the offset of the
    buffer in the outermost document, for error messages.  ``bin`` values
    come back as ``bytes``, or with ``views`` as memoryviews of the buffer
    (an ndarray's payload, read without a copy)."""

    def __init__(self, buf, base: int = 0, views: bool = False):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.base = base
        self.views = views

    def _take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack data ends early: {n} bytes wanted at "
                             f"offset {self.base + self.pos}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def _unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self._take(n))[0]

    def value(self) -> Any:
        at = self.base + self.pos
        b = self._unpack(">B", 1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F, at)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self._unpack(*_FIXED[b])
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b], at)
        if b in _SIZED:
            kind, width = _SIZED[b]
            n = self._unpack(_LEN[width], width)
            if kind == "str":
                return self._str(n, at)
            if kind == "bin":
                return self._take(n) if self.views else bytes(self._take(n))
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            return self._ext(n, at)
        raise ValueError(f"unknown msgpack type byte 0x{b:02x} at offset {at}")

    def _str(self, n: int, at: int) -> str:
        try:
            return str(self._take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack str at offset {at} is not UTF-8") from e

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, n: int, at: int) -> Any:
        code = self._unpack(">b", 1)
        start = self.base + self.pos
        data = self._take(n)
        if code == EXT_NDARRAY:
            return _ndarray(data, start)
        if code == EXT_NPSCALAR:
            arr = _ndarray(data, start)
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        if code == EXT_COMPLEX:
            real, imag = _Reader(data, start).value()
            return complex(real, imag)
        raise ValueError(f"unknown msgpack ext code {code} at offset {at}")


def _ndarray(data: memoryview, base: int):
    """A flax ndarray payload: ``(shape, dtype name, bytes)``.  Numeric
    dtypes come back as read-only numpy views of the buffer; bfloat16 as a
    ``torch.bfloat16`` tensor (a copy)."""
    try:
        shape, name, raw = _Reader(data, base, views=True).value()
    except (TypeError, ValueError) as e:
        raise ValueError(f"malformed flax ndarray at offset {base}: {e}") from e
    if isinstance(name, memoryview):
        name = bytes(name).decode()
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"flax ndarray at offset {base} has dtype {name!r}, "
                         "which numpy does not know") from e
    if dtype.hasobject:
        raise ValueError(f"flax ndarray at offset {base} has an object dtype")
    return np.frombuffer(raw, dtype).reshape(shape)


def unpackb(data) -> Any:
    """One msgpack document (the whole of ``data``) as Python values:
    maps as dicts, arrays as lists, bin as ``bytes``, flax's ext types as
    arrays, complex numbers and scalars."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the "
                         f"msgpack document at offset {reader.pos}")
    return out


def _unchunk(node: dict, path: str):
    try:
        shape = tuple(int(node["shape"][str(i)]) for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        if chunks and isinstance(chunks[0], torch.Tensor):
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)
    except (KeyError, TypeError, ValueError, RuntimeError) as e:
        raise ValueError(f"chunked leaf {path!r} cannot be joined: {e}") from e


def _restore(node: Any, path: str) -> Any:
    if isinstance(node, dict):
        if node.get(CHUNKED) is True:
            return _unchunk(node, path)
        return {k: _restore(v, f"{path}/{k}") for k, v in node.items()}
    return node


def msgpack_restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: the state dict of ``data``,
    chunked leaves joined."""
    return _restore(unpackb(data), "")


def read_file(path: str) -> Any:
    """The state dict of one ``.msgpack`` file; its numpy leaves are
    read-only views of the file's bytes."""
    with open(path, "rb") as fh:
        return msgpack_restore(fh.read())
