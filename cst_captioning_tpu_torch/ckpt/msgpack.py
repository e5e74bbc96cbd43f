"""A pure-Python msgpack decoder for the JAX package's checkpoints.

``flax.serialization.to_bytes`` writes a TrainState as msgpack: nested
maps with string keys, numpy arrays as ext type 1 (a packed ``(shape,
dtype name, C-order bytes)``), numpy scalars as ext type 3 (the same,
0-d), complex numbers as ext type 2, and arrays over 2**30 bytes split
into ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``
maps. :func:`restore` reads all of it with numpy and the standard library
only (the machine the port trains on need not have ``msgpack`` or
``flax``); it gives what ``flax.serialization.msgpack_restore`` gives,
with each ``bfloat16`` array as its ``uint16`` bit patterns (numpy has no
bfloat16; ``convert.py`` reads such an array back as a bfloat16 tensor,
bit for bit).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Malformed or unsupported msgpack input."""


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError(
                f"truncated msgpack: need {n} bytes at offset {self.pos}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H",
                                         0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise MsgpackError(f"unknown msgpack type byte 0x{b:02x} at offset "
                           f"{self.pos - 1}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == EXT_COMPLEX:
            re, im = unpackb(data)
            return complex(re, im)
        raise MsgpackError(f"unsupported msgpack ext type {code}")


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buf = unpackb(data)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        arr = np.frombuffer(buf, dtype="<u2").astype(np.uint16)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(dtype))
    return arr.reshape(tuple(shape)).copy()


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that fills ``data``."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} trailing bytes")
    return out


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(blob: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the state dict of a
    ``to_bytes`` blob, chunked arrays joined."""
    return _unchunk(unpackb(blob))
