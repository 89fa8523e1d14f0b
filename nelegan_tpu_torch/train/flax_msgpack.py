"""A reader of `flax.serialization.to_bytes` blobs, in plain Python.

The reference package writes its checkpoints with flax's msgpack
serialization (`nelegan_tpu/train/checkpoint.py:54-90`).  The port needs
neither flax nor the `msgpack` package to read them: this module decodes
the subset of msgpack that flax writes,

  * maps, arrays, str, bin, ints, floats, nil and bool;
  * ext 1, an ndarray: a msgpack ``(shape, dtype name, C-order bytes)``;
  * ext 2, a native complex: a msgpack ``(real, imag)``;
  * ext 3, a numpy scalar: an ndarray of shape () returned as its scalar;

and flax's chunked-array dict (``{"__msgpack_chunked_array__": True,
"shape": ..., "chunks": ...}``, written for leaves over 2^30 bytes) is
joined back into one array.  Tuples and named tuples arrive as the dicts
flax made of them (``{"0": ..., "1": ...}``, field names).  Arrays come
back as numpy arrays that own their data.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_SCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("mapping", ">H"), 0xDF: ("mapping", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            return getattr(self, kind)(self.unpack(fmt))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:                     # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_SCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            re, im = loads(payload)
            return complex(re, im)
        raise ValueError(f"msgpack: unsupported ext type {code}")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype, buf = loads(payload)
    try:
        dt = np.dtype(dtype)
    except TypeError as e:
        raise ValueError(f"flax msgpack: array dtype {dtype!r} has no numpy "
                         f"counterpart") from e
    return np.frombuffer(buf, dtype=dt).reshape(tuple(shape)).copy()


def _unchunk(tree):
    """Join flax's chunked-array dicts back into arrays, anywhere in
    `tree`."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        try:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
        except (KeyError, TypeError) as e:
            raise ValueError("flax msgpack: malformed chunked array") from e
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data: bytes) -> Any:
    """Decode one msgpack value from `data` (all of it)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the "
                         f"value")
    return out


def restore(data: bytes) -> Any:
    """`flax.serialization.msgpack_restore`: the tree of a `to_bytes` blob,
    chunked arrays joined."""
    return _unchunk(loads(data))


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return restore(f.read())
