"""A read-only subset of HDF5 in numpy and ``zlib``, in place of h5py (the
card's machine has none), for the MATLAB v7.3 files the dataset converters
read (``nyu_depth_v2_labeled.mat``, ``SUNRGBD2Dseg.mat``).

It reads what MATLAB v7.3 and h5py's default (earliest) file format write:

* a version 0 or 1 superblock, looked for at offsets 0, 512, 1024, 2048, …
  (MATLAB puts a 512-byte user block before it);
* version 1 and 2 object headers and their continuation blocks;
* symbol-table groups: a version 1 B-tree of symbol-table nodes (SNOD) with
  the names in a local heap;
* fixed-point, IEEE floating-point and object-reference datatypes;
* data layout version 3: compact, contiguous, and chunked over a version 1
  B-tree, with the deflate and shuffle filters (fletcher32 checksums are
  stripped) and the fill value for chunks that were never written;
* ``f[ref]``: the object an object reference points at.

A dataset reads whole as ``np.asarray(ds)`` (or ``ds[()]``, ``ds[...]``,
``ds[:]``) in h5py's order, its dataspace's dimensions as stored; ``ds[i]``
and ``ds[a:b]`` read one index or a range of its first axis, decompressing
only the chunks that cover it. References read as ``Reference`` objects. Anything else raises
``NotImplementedError`` naming the structure and the file: superblock
versions 2 and 3, layout version 4 chunk indexes,
new-style (link message) and fractal-heap (dense) groups, shared messages,
other datatypes and filters.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 1, 2, 3, 4, 5
_LINK, _LAYOUT, _GROUP_INFO, _FILTERS, _CONTINUATION = 6, 8, 10, 11, 16
_SYMBOL_TABLE = 17

_FILTER_DEFLATE, _FILTER_SHUFFLE, _FILTER_FLETCHER32 = 1, 2, 3


@dataclass(frozen=True)
class Reference:
    """An object reference: the address of the object's header."""

    address: int

    def __bool__(self) -> bool:
        return self.address not in (0, UNDEFINED)


class File:
    """An HDF5 file opened for reading: ``f["a/b"]``, ``f[ref]``, ``"a" in
    f``, ``f.keys()``; a context manager."""

    def __init__(self, path: str, mode: str = "r"):
        if mode != "r":
            raise ValueError(f"{path}: hdf5.File opens files read-only")
        self.path = path
        self._fh = open(path, "rb")
        try:
            self._read_superblock()
            self._root = Group(self, self._root_header)
        except BaseException:
            self._fh.close()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        self._fh.close()

    # ----------------------------------------------------------- raw reads
    def _read(self, address: int, size: int) -> bytes:
        self._fh.seek(self._base + address)
        data = self._fh.read(size)
        if len(data) != size:
            raise ValueError(f"{self.path}: truncated file (wanted {size} "
                             f"bytes at {address})")
        return data

    def _unsupported(self, what: str):
        return NotImplementedError(f"{self.path}: {what} is not supported "
                                   "(dynmm_tpu_torch.data.hdf5)")

    def _addr(self, buf: bytes, pos: int) -> int:
        return int.from_bytes(buf[pos:pos + self._so], "little")

    def _length(self, buf: bytes, pos: int) -> int:
        return int.from_bytes(buf[pos:pos + self._sl], "little")

    def _read_superblock(self) -> None:
        self._fh.seek(0, 2)
        size = self._fh.tell()
        offset = 0
        while offset + 8 <= size:
            self._fh.seek(offset)
            if self._fh.read(8) == SIGNATURE:
                break
            offset = 512 if offset == 0 else offset * 2
        else:
            raise ValueError(f"{self.path}: not an HDF5 file (no superblock "
                             "signature at 0, 512, 1024, ...)")
        self._fh.seek(offset)
        head = self._fh.read(24)
        version = head[8]
        if version not in (0, 1):
            raise self._unsupported(f"superblock version {version}")
        self._so, self._sl = head[13], head[14]
        self._undefined = (1 << 8 * self._so) - 1  # an unset address
        pos = 24 + (4 if version == 1 else 0)
        self._fh.seek(offset + pos)
        rest = self._fh.read(4 * self._so + 40 + 2 * self._so)
        # addresses are relative to the superblock, whatever base address
        # it stores (the HDF5 library's rule)
        self._base = offset
        entry = rest[4 * self._so:]
        self._root_header = self._addr(entry, self._so)

    # ------------------------------------------------------ object headers
    def _messages(self, address: int) -> list[tuple[int, bytes]]:
        """(type, data) of every message of the object header at
        ``address``, continuation blocks followed."""
        prefix = self._read(address, 16)
        if prefix[:4] == b"OHDR":
            return self._messages_v2(address)
        if prefix[0] != 1:
            raise self._unsupported(f"object header version {prefix[0]}")
        n_msgs, = struct.unpack_from("<H", prefix, 2)
        hsize, = struct.unpack_from("<I", prefix, 8)
        blocks = [(address + 16, hsize)]
        out = []
        while blocks and len(out) < n_msgs:
            start, length = blocks.pop(0)
            buf = self._read(start, length)
            pos = 0
            while pos + 8 <= length and len(out) < n_msgs:
                mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
                data = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if flags & 2:
                    raise self._unsupported(
                        f"a shared object header message (type {mtype})")
                if mtype == _CONTINUATION:
                    blocks.append((self._addr(data, 0),
                                   self._length(data, self._so)))
                out.append((mtype, data))
        return out

    def _messages_v2(self, address: int) -> list[tuple[int, bytes]]:
        """The messages of a version 2 object header ("OHDR", as new-style
        groups have), continuation blocks ("OCHK") followed."""
        head = self._read(address, 6)
        flags = head[5]
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        size = int.from_bytes(self._read(address + pos, width), "little")
        blocks = [(address + pos + width, size)]
        out = []
        while blocks:
            start, length = blocks.pop(0)
            buf = self._read(start, length)
            at = 0
            while at + 4 <= length:
                mtype, msize, mflags = buf[at], *struct.unpack_from(
                    "<HB", buf, at + 1)
                at += 4 + (2 if flags & 4 else 0)
                data = buf[at:at + msize]
                at += msize
                if mflags & 2:
                    raise self._unsupported(
                        f"a shared object header message (type {mtype})")
                if mtype == _CONTINUATION:
                    # the block's "OCHK" signature, then messages, checksum
                    blocks.append((self._addr(data, 0) + 4,
                                   self._length(data, self._so) - 8))
                out.append((mtype, data))
        return out

    def _object(self, address: int, name: str):
        msgs = self._messages(address)
        types = {t for t, _ in msgs}
        if _LAYOUT in types:
            return Dataset(self, address, name, msgs)
        if _SYMBOL_TABLE in types:
            return Group(self, address, name, msgs)
        if _LINK_INFO in types:
            info = dict(msgs)[_LINK_INFO]
            flags = info[1]
            heap = self._addr(info, 2 + (8 if flags & 1 else 0))
            if heap != self._undefined:
                raise self._unsupported("a fractal-heap (dense) group")
            raise self._unsupported("a new-style (link message) group")
        if _LINK in types or _GROUP_INFO in types:
            raise self._unsupported("a new-style (link message) group")
        raise self._unsupported(f"the object at address {address} (neither "
                                "a dataset nor a symbol-table group)")

    def __getitem__(self, key):
        if isinstance(key, Reference):
            if not key:
                raise ValueError(f"{self.path}: null reference")
            return self._object(key.address, f"<ref {key.address}>")
        return self._root[key]

    def __contains__(self, key) -> bool:
        return key in self._root

    def keys(self):
        return self._root.keys()


class Group:
    """A symbol-table group: its members by name."""

    def __init__(self, f: File, address: int, name: str = "/",
                 msgs: list | None = None):
        self.file, self.name = f, name
        msgs = f._messages(address) if msgs is None else msgs
        table = dict(msgs).get(_SYMBOL_TABLE)
        if table is None:
            f._object(address, name)  # raises what it is, unless a dataset
            raise ValueError(f"{f.path}: {name} is a dataset, not a group")
        btree, heap = f._addr(table, 0), f._addr(table, f._so)
        self._members = self._read_members(btree, self._heap(heap))

    def _heap(self, address: int) -> bytes:
        f = self.file
        head = f._read(address, 8 + 2 * f._sl + f._so)
        if head[:4] != b"HEAP":
            raise ValueError(f"{f.path}: bad local heap at {address}")
        size = f._length(head, 8)
        return f._read(f._addr(head, 8 + 2 * f._sl), size)

    def _read_members(self, btree: int, heap: bytes) -> dict[str, int]:
        f = self.file
        members: dict[str, int] = {}
        for child in _btree_children(f, btree, node_type=0, key_size=f._sl):
            node = f._read(child, 8)
            if node[:4] != b"SNOD":
                raise ValueError(f"{f.path}: bad symbol-table node at "
                                 f"{child}")
            n, = struct.unpack_from("<H", node, 6)
            esize = 2 * f._so + 24
            entries = f._read(child + 8, n * esize)
            for i in range(n):
                e = entries[i * esize:(i + 1) * esize]
                off, header = f._addr(e, 0), f._addr(e, f._so)
                end = heap.index(b"\0", off)
                members[heap[off:end].decode()] = header
        return members

    def keys(self):
        return list(self._members)

    def __contains__(self, key) -> bool:
        try:
            self[key]
        except KeyError:
            return False
        return True

    def __getitem__(self, key: str):
        head, _, rest = key.strip("/").partition("/")
        if not head:
            return self
        if head not in self._members:
            raise KeyError(f"{self.file.path}: no member {head!r} in "
                           f"{self.name}")
        obj = self.file._object(self._members[head],
                                f"{self.name.rstrip('/')}/{head}")
        return obj[rest] if rest else obj


def _btree_children(f: File, address: int, node_type: int, key_size: int,
                    keys: bool = False):
    """Walk a version 1 B-tree: the level-0 child addresses, in order (with
    ``keys``, (left key bytes, address) pairs)."""
    head_size = 8 + 2 * f._so
    stack = [address]
    while stack:
        addr = stack.pop(0)
        head = f._read(addr, head_size)
        if head[:4] != b"TREE" or head[4] != node_type:
            raise ValueError(f"{f.path}: bad B-tree node at {addr}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        body = f._read(addr + head_size,
                       used * (key_size + f._so) + key_size)
        kids = []
        for i in range(used):
            pos = i * (key_size + f._so)
            kids.append((body[pos:pos + key_size],
                         f._addr(body, pos + key_size)))
        if level:
            stack[:0] = [a for _, a in kids]
        else:
            yield from (kids if keys else (a for _, a in kids))


class Dataset:
    """A dataset: ``shape``, ``dtype``, ``np.asarray(ds)``, ``ds[i]``."""

    def __init__(self, f: File, address: int, name: str, msgs: list):
        self.file, self.name = f, name
        m = {}
        for t, d in msgs:
            m.setdefault(t, d)
        self.shape = self._dataspace(m[_DATASPACE])
        self.dtype, self._ref = self._datatype(m[_DATATYPE])
        self._filters = self._pipeline(m.get(_FILTERS))
        self._fill = self._fill_value(m)
        self._layout(m[_LAYOUT])
        self._chunk_index = None
        self._cache: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------ messages
    def _unsupported(self, what: str):
        return self.file._unsupported(f"{what} (dataset {self.name})")

    def _dataspace(self, d: bytes) -> tuple[int, ...]:
        version, rank, flags = d[0], d[1], d[2]
        if version == 1:
            pos = 8
        elif version == 2:
            if d[3] == 2:
                raise self._unsupported("a null dataspace")
            pos = 4
        else:
            raise self._unsupported(f"dataspace version {version}")
        sl = self.file._sl
        return tuple(int.from_bytes(d[pos + i * sl:pos + (i + 1) * sl],
                                    "little") for i in range(rank))

    def _datatype(self, d: bytes):
        cls, bits = d[0] & 15, d[1] | d[2] << 8 | d[3] << 16
        size, = struct.unpack_from("<I", d, 4)
        order = ">" if bits & 1 else "<"
        if cls == 0:  # fixed-point
            offset, precision = struct.unpack_from("<HH", d, 8)
            if offset or precision != 8 * size or size not in (1, 2, 4, 8):
                raise self._unsupported(
                    f"a {precision}-bit fixed-point type at bit {offset} "
                    f"of {size} bytes")
            return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"), False
        if cls == 1:  # IEEE floating point
            if bits & 0x40 or size not in (2, 4, 8):
                raise self._unsupported(f"a {size}-byte non-IEEE float type")
            return np.dtype(f"{order}f{size}"), False
        if cls == 7:  # reference
            if bits & 15 != 0:
                raise self._unsupported("dataset region references")
            return np.dtype(object), True
        names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
                 6: "compound", 8: "enumerated", 9: "variable-length",
                 10: "array"}
        raise self._unsupported(f"the {names.get(cls, cls)} datatype class")

    def _pipeline(self, d: bytes | None) -> list[tuple[int, int]]:
        """[(filter id, client data), ...] in the order they were applied."""
        if d is None:
            return []
        version, n = d[0], d[1]
        pos = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            fid, = struct.unpack_from("<H", d, pos)
            pos += 2
            name_len = 0
            if version == 1 or fid >= 256:
                name_len, = struct.unpack_from("<H", d, pos)
                pos += 2
            _, ncd = struct.unpack_from("<HH", d, pos)
            pos += 4
            if version == 1:
                name_len = (name_len + 7) // 8 * 8
            pos += name_len
            cd = struct.unpack_from(f"<{ncd}I", d, pos)
            pos += 4 * ncd
            if version == 1 and ncd % 2:
                pos += 4
            if fid not in (_FILTER_DEFLATE, _FILTER_SHUFFLE,
                           _FILTER_FLETCHER32):
                raise self._unsupported(f"filter {fid}")
            out.append((fid, cd[0] if cd else 0))
        return out

    def _fill_value(self, m: dict) -> bytes | None:
        d = m.get(_FILL)
        if d is not None:
            version = d[0]
            if version in (1, 2):
                defined = d[3]
                if defined and (version == 1 or defined):
                    size, = struct.unpack_from("<I", d, 4)
                    return d[8:8 + size] if size else None
                return None
            if version == 3:
                flags = d[1]
                if flags & 0x20:
                    size, = struct.unpack_from("<I", d, 2)
                    return d[6:6 + size] if size else None
                return None
            raise self._unsupported(f"fill value message version {version}")
        d = m.get(_FILL_OLD)
        if d is not None:
            size, = struct.unpack_from("<I", d, 0)
            return d[4:4 + size] if size else None
        return None

    def _layout(self, d: bytes) -> None:
        version, cls = d[0], d[1]
        if version == 4:
            raise self._unsupported("data layout version 4 (its chunk "
                                    "indexes)")
        if version != 3:
            raise self._unsupported(f"data layout version {version}")
        f = self.file
        self._layout_class = cls
        if cls == 0:
            size, = struct.unpack_from("<H", d, 2)
            self._compact = d[4:4 + size]
        elif cls == 1:
            self._address = f._addr(d, 2)
        elif cls == 2:
            rank = d[2]
            self._btree = f._addr(d, 3)
            dims = struct.unpack_from(f"<{rank}I", d, 3 + f._so)
            self._chunk = tuple(dims[:-1])
        else:
            raise self._unsupported(f"layout class {cls}")

    # --------------------------------------------------------------- reads
    @property
    def _item(self) -> np.dtype:
        return np.dtype(f"<u{self.file._so}") if self._ref else self.dtype

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def _empty(self, shape) -> np.ndarray:
        out = np.empty(shape, self._item)
        if self._fill is not None:
            out[...] = np.frombuffer(self._fill[:self._item.itemsize],
                                     self._item)[0]
        else:
            out[...] = 0
        return out

    def _finish(self, raw: np.ndarray) -> np.ndarray:
        if not self._ref:
            return raw.astype(self.dtype.newbyteorder("="), copy=False)
        out = np.empty(raw.shape, object)
        flat = out.reshape(-1)
        for i, a in enumerate(raw.reshape(-1).tolist()):
            flat[i] = Reference(a)
        return out

    def _read_rows(self, start: int, stop: int) -> np.ndarray:
        """Rows ``start:stop`` of the first axis (the raw item type)."""
        shape = (stop - start, *self.shape[1:]) if self.shape else ()
        isz = self._item.itemsize
        if self._layout_class == 0:
            whole = np.frombuffer(self._compact, self._item,
                                  count=self.size).reshape(self.shape)
            return whole[start:stop].copy() if self.shape else whole.copy()
        if self._layout_class == 1:
            if self._address == self.file._undefined:
                return self._empty(shape)
            row = int(np.prod(self.shape[1:], dtype=np.int64)) * isz
            count = int(np.prod(shape, dtype=np.int64))
            data = self.file._read(self._address + start * row, count * isz)
            return np.frombuffer(data, self._item).reshape(shape).copy()
        return self._read_chunked(start, stop, shape)

    def _chunks(self) -> list[tuple[tuple[int, ...], int, int, int]]:
        """(offsets, stored size, filter mask, address) of every chunk."""
        if self._chunk_index is None:
            f, rank = self.file, len(self._chunk)
            key_size = 8 + 8 * (rank + 1)
            out = []
            if self._btree != self.file._undefined:
                for key, addr in _btree_children(f, self._btree, 1, key_size,
                                                 keys=True):
                    size, mask = struct.unpack_from("<II", key, 0)
                    offs = struct.unpack_from(f"<{rank}Q", key, 8)
                    out.append((offs, size, mask, addr))
            self._chunk_index = out
        return self._chunk_index

    def _decode_chunk(self, size: int, mask: int, addr: int) -> np.ndarray:
        data = self.file._read(addr, size)
        isz = self._item.itemsize
        for i, (fid, _) in reversed(list(enumerate(self._filters))):
            if mask >> i & 1:
                continue
            if fid == _FILTER_DEFLATE:
                data = zlib.decompress(data)
            elif fid == _FILTER_SHUFFLE:
                raw = np.frombuffer(data, np.uint8)
                n = raw.size // isz
                data = raw[:n * isz].reshape(isz, n).T.tobytes() \
                    + raw[n * isz:].tobytes()
            elif fid == _FILTER_FLETCHER32:
                data = data[:-4]
        count = int(np.prod(self._chunk, dtype=np.int64))
        return np.frombuffer(data, self._item, count=count).reshape(
            self._chunk)

    def _read_chunked(self, start: int, stop: int, shape) -> np.ndarray:
        out = self._empty(shape)
        c0 = self._chunk[0]
        cache = {}
        for offs, size, mask, addr in self._chunks():
            if offs[0] >= stop or offs[0] + c0 <= start:
                continue
            chunk = self._cache.get(addr)
            if chunk is None:
                chunk = self._decode_chunk(size, mask, addr)
            cache[addr] = chunk
            src, dst = [], []
            for d, (o, c, n) in enumerate(zip(offs, self._chunk,
                                              self.shape)):
                lo, hi = (max(o, start), min(o + c, stop)) if d == 0 else \
                    (o, min(o + c, n))
                src.append(slice(lo - o, hi - o))
                dst.append(slice(lo - start, hi - start) if d == 0
                           else slice(lo, hi))
            out[tuple(dst)] = chunk[tuple(src)]
        # keep the chunks of this read: a read of the next index often
        # lands in them again
        self._cache = cache
        return out

    def __array__(self, dtype=None, copy=None):
        if not self.shape:
            out = self._finish(self._read_rows(0, 1))
        else:
            out = self._finish(self._read_rows(0, self.shape[0]))
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)) and self.shape:
            i = int(key) + (self.shape[0] if key < 0 else 0)
            if not 0 <= i < self.shape[0]:
                raise IndexError(f"index {key} out of range for axis 0 of "
                                 f"{self.name} ({self.shape[0]})")
            return self._finish(self._read_rows(i, i + 1))[0]
        if key is Ellipsis or (isinstance(key, tuple) and key == ()):
            return np.asarray(self)
        if isinstance(key, slice) and key.step in (None, 1) and self.shape:
            start, stop, _ = key.indices(self.shape[0])
            return self._finish(self._read_rows(start, max(start, stop)))
        raise self._unsupported(f"the selection {key!r} (whole reads, one "
                                "index or a range of the first axis are)")
