"""A reader for the files that ``flax.serialization.to_bytes`` writes, without
the ``msgpack`` package: ``vil_tpu``'s default checkpoints
(``vil_tpu/utils/checkpoint.py``, CKPT_BACKEND 'msgpack').

Such a file is one msgpack object: maps with string keys (flax writes tuples
and namedtuples, an optax state among them, as maps keyed ``'0'``, ``'1'``,
... or by field name, ``count``, ``mu``, ``nu``), arrays, str, bin, ints,
floats, bool and nil, and two of flax's extension types:

* ext 1, an ndarray: a msgpack array ``(shape, dtype name, C-order bytes)``;
* ext 3, a numpy scalar: the same, returned as a 0-d array's item.

Ext 2 (a Python complex) raises. Arrays above 1 GiB, which flax splits into
``__msgpack_chunked_array__`` maps, are joined again.

The file is mapped (``mmap``) and every array is ``np.frombuffer`` on a slice
of the mapping, read-only, with no Python work per element and no second copy
of the file. A ``bfloat16`` array (TPU.PARAM_DTYPE bfloat16) is widened to
float32 through its bits, exactly: numpy has no bfloat16 without
``ml_dtypes``. Other dtype names numpy does not know raise.
"""
from __future__ import annotations

import mmap
import struct

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A cursor over one buffer of msgpack bytes."""

    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack data truncated at byte {self.pos} (want {n} more, "
                             f"{len(self.buf) - self.pos} left)")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool = False):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _LENGTHS:  # bin, ext, str, array, map with a length field
            kind, fmt = _LENGTHS[b]
            n = self.unpack(fmt)
            if kind == "bin":  # a view inside an ndarray record, else bytes
                return self.take(n) if raw else bytes(self.take(n))
            if kind == "ext":
                return self.ext(self.unpack(">b"), n)
            if kind == "str":
                return self.str(n, raw)
            if kind == "array":
                return [self.obj(raw) for _ in range(n)]
            return self.map(n, raw)
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack object")

    def str(self, n: int, raw: bool):
        data = self.take(n)
        return bytes(data) if raw else str(data, "utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj(raw)
            out[key] = self.obj(raw)
        return out

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            raise ValueError("msgpack ext 2 (a Python complex) is not read")
        raise ValueError(f"msgpack ext {code} is not one of flax's")


_LENGTHS = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_SCALARS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}


def bfloat16_to_float32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 values held as their uint16 bits, widened exactly to float32."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _ndarray(data: memoryview) -> np.ndarray:
    """Flax's ndarray record: (shape, dtype name, bytes), a view of ``data``."""
    inner = _Reader(data)
    shape, name, buf = inner.obj(raw=True)
    if not isinstance(buf, memoryview):
        raise ValueError("a flax ndarray record without its bytes")
    name = name.decode()
    if name == "bfloat16":
        arr = bfloat16_to_float32(np.frombuffer(buf, np.uint16))
    else:
        try:
            dtype = np.dtype(name)
        except TypeError as e:
            raise ValueError(f"dtype {name!r} of a flax array is unknown to numpy") from e
        arr = np.frombuffer(buf, dtype)
    return arr.reshape(shape)


def _unchunk(tree):
    """Join the arrays that flax split into chunks, in place."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        for key, val in tree.items():
            tree[key] = _unchunk(val)
    return tree


def loads(data) -> object:
    """The object of msgpack bytes that flax wrote (any buffer)."""
    reader = _Reader(memoryview(data).cast("B"))
    out = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return _unchunk(out)


def load(path: str) -> object:
    """The tree of a file that ``flax.serialization.to_bytes`` wrote. Its
    arrays are read-only views of the file's mapping, which stays open while
    any of them lives."""
    with open(path, "rb") as f:
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return loads(mapped)


def starts_a_map(path: str) -> bool:
    """Whether the file starts with a msgpack map, as every flax checkpoint
    does (a zip archive, ``torch.save``'s format, starts with ``PK``)."""
    with open(path, "rb") as f:
        head = f.read(1)
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))
