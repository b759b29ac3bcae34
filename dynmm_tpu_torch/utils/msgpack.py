"""A pure-Python reader and writer of flax's msgpack format.

``flax.serialization.msgpack_serialize`` writes a tree of dicts (str keys),
lists, Python scalars and numpy arrays with the ``msgpack`` package; the
card has neither ``flax`` nor ``msgpack``, so the port reads and writes the
same bytes itself. Extension types (``flax/serialization.py``):

* 1, ndarray: the payload is the msgpack of ``(shape, dtype name, raw C-order
  bytes)``, the dtype name a str and the bytes a bin;
* 2, complex: the payload is the msgpack of ``(real, imag)``;
* 3, numpy scalar: an ndarray payload of shape ``()``.

Arrays over 2**30 bytes, which flax splits into ``__msgpack_chunked_array__``
dicts, are joined on reading; the writer raises on them (no checkpoint of the
port's models has one). ``packb`` chooses the same encodings as ``msgpack``'s
packer with ``use_bin_type=True``: the smallest int, float64 for floats, str
for str and bin for bytes; and dict keys go in sorted order, as flax's copy
of the tree through ``jax.tree_util`` leaves them. So a tree written here is
byte-identical to flax's.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_LEAF_BYTES = 2 ** 30


# ------------------------------------------------------------------ writer
def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    """A length header: the fix form below ``fix_max``, then 8/16/32-bit
    (``codes`` has None-able 8-bit code first)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if v < top:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")
    elif v >= -32:
        out += struct.pack(">b", v)
    else:
        for code, fmt, low in ((0xD0, ">Bb", -(1 << 7)), (0xD1, ">Bh", -(1 << 15)),
                               (0xD2, ">Bi", -(1 << 31)), (0xD3, ">Bq", -(1 << 63))):
            if v >= low:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out += struct.pack(">Bb", fixext[n], code)
    elif n < 1 << 8:
        out += struct.pack(">BBb", 0xC7, n, code)
    elif n < 1 << 16:
        out += struct.pack(">BHb", 0xC8, n, code)
    else:
        out += struct.pack(">BIb", 0xC9, n, code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    if arr.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes: flax would chunk it, "
                         "which this writer does not")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in sorted(obj.items()):
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif isinstance(obj, complex):
        _pack_ext(out, EXT_COMPLEX, packb([obj.real, obj.imag]))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` with flax's extension types."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# ------------------------------------------------------------------ reader
class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax reads the ndarray payload so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from(data)[()]
        if code == EXT_COMPLEX:
            re, im = unpackb(data)
            return complex(re, im)
        raise ValueError(f"unknown msgpack extension type {code}")

    def read(self):
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str_(n)
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self.map_(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"invalid msgpack byte 0x{b:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ndarray_from(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 arrays need ml_dtypes, which the port "
                         "does not use")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape, order="C")


def _unchunk(tree):
    """Join flax's ``__msgpack_chunked_array__`` leaves."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes, raw: bool = False):
    """Decode one msgpack object (with flax's extension types)."""
    reader = _Reader(data, raw)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack object")
    return obj


def msgpack_serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts, lists,
    scalars and numpy arrays."""
    return packb(tree)


def msgpack_restore(data: bytes):
    """``flax.serialization.msgpack_restore``: the tree, arrays as
    read-only numpy views of ``data``."""
    return _unchunk(unpackb(data))
