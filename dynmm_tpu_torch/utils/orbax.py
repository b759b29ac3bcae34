"""Orbax checkpoints without orbax, tensorstore or a zstd package (port of
``dynmm_tpu/utils/checkpoint.py::save_orbax`` / ``load_orbax``).

The JAX package saves ``{"epoch": epoch, "state": state}`` with orbax's
``StandardCheckpointer`` (orbax 0.11). The directory it writes:

* ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's key path (the
  repr of a tuple of str keys) to its ``key_metadata`` (key_type 1 for a
  sequence index, 2 for a dict key or field) and ``value_metadata``
  (``value_type`` ``jax.Array``, ``np.ndarray`` or ``scalar``; an empty
  node is ``None``/``Dict``/... with ``skip_deserialize``);
  ``_CHECKPOINT_METADATA``, ``_sharding`` (the jax.Array leaves'
  shardings) and ``array_metadatas/process_<n>`` (their write and chunk
  shapes) are JSON too.
* An OCDBT key-value store (tensorstore's format): ``manifest.ocdbt`` at
  the root, B-tree nodes and values in data files ``d/<id>``, here and in
  the per-process sub-databases ``ocdbt.process_<n>/`` that the root's
  nodes point into. Each leaf is a zarr v2 array under the key prefix
  ``".".join(path)``: ``<name>/.zarray`` (JSON: shape, chunks, dtype,
  compressor ``zstd``) and one key per chunk, ``<name>/i.j...`` (``0``
  for a 0-d array), each a zstd frame of the C-order chunk. A mesh-sharded
  jax.Array leaf has one chunk per shard.

OCDBT layout (manifest and B-tree node files; checked against files that
tensorstore writes): magic (u32 BE: 0x0cdb3a2a manifest, 0x0cdb20de
node), file length (u64 LE), version and compression (varints; 1 = the
rest is one zstd frame), the body, CRC-32C (u32 LE) of all that precedes.
Varints are LEB128. A data file table is ``n``, ``n-1`` prefix lengths
shared with the previous path, ``n`` suffix lengths, ``n`` base-path
lengths, then the suffixes; paths are relative to the database root.

* Manifest body: the config (uuid[16], manifest kind, max inline value
  bytes, max decoded node bytes, version tree arity log2 (byte),
  compression (1 = zstd, then an i32 LE level)); a data file table; the
  newest versions: ``n``, then per-column generation numbers, root heights
  (bytes), root node file ids, offsets, lengths, key counts, tree bytes,
  indirect value bytes, commit times (u64 LE); then older versions' tree
  nodes, not needed to read the newest.
* B-tree node body: height (byte), a data file table, ``n`` entries, key
  prefix lengths (shared with the previous key), key suffix lengths; an
  interior node's subtree common prefix lengths; the key suffixes. A leaf
  then holds value lengths, value kinds (0 inline, 1 in a data file), the
  indirect values' file ids and offsets, and the inline values. An
  interior node holds its children's file ids, offsets, lengths and
  statistics; a child's keys follow its entry key's first
  ``subtree_common_prefix_length`` bytes.

``load_orbax`` reads all of this through ``native/zstd.cpp`` (the zstd
decoder and CRC-32C, built at first use; no fallback). ``save_orbax``
writes one root database with one data file: the values over 1024 bytes,
then the single leaf node; OCDBT files and zarr chunks are zstd frames of
raw blocks (valid frames, so no compressor is needed); the JSON files as
orbax writes them, array leaves as ``np.ndarray``. JAX's ``load_orbax``
restores such a directory, with or without a (mesh-sharded) target.

Leaves come back as numpy arrays; bfloat16 ones (numpy has no such dtype)
as ``torch.bfloat16`` tensors. Sequences come back as dicts keyed by the
index string and empty nodes as ``{}``: flax's state-dict layout, the one
``checkpoint.py`` reads from msgpack. Under a target (``load_tree``) the
leaves are ``OrbaxArray``s that read their chunks when indexed or
converted, so a state on the port's mesh (``train/seg.py::TrainState``)
reads on each rank only the chunks of its 'model' slices. Under a mesh,
``save_orbax`` writes what rank 0 gathers, one chunk per 'model' slice
along the sharded (last flax) axis.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import struct
import time
import uuid
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from dynmm_tpu_torch import native

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MAX_INLINE_VALUE_BYTES = 1024  # orbax's config: .zarray inline, chunks not
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
NO_NODE = 2 ** 64 - 1  # an empty tree's root offset
ZSTD_MAGIC = 0xFD2FB528
ZSTD_RAW_BLOCK = 1 << 17
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
ARRAY_TYPES = ("np.ndarray", "jax.Array")
SEQUENCE, DICT_KEY = 1, 2  # orbax's key_type


# --------------------------------------------------------------- encoding
class _Cursor:
    """Reads LEB128 varints, bytes and fixed-width fields from ``buf``."""

    def __init__(self, buf: bytes, what: str, pos: int = 0):
        self.buf, self.what, self.pos = buf, what, pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.what}: truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            c = self.byte()
            out |= (c & 0x7F) << shift
            if not c & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def zstd_frame(data) -> bytes:
    """A zstd frame of raw blocks holding ``data``: single segment, the
    content size in 8 bytes, no checksum (RFC 8878 §3.1.1)."""
    view = memoryview(data).cast("B")
    n = len(view)
    parts = [struct.pack("<IBQ", ZSTD_MAGIC, 0xE0, n)]
    if n == 0:
        parts.append((1).to_bytes(3, "little"))  # one empty last raw block
    for off in range(0, n, ZSTD_RAW_BLOCK):
        size = min(ZSTD_RAW_BLOCK, n - off)
        last = off + size >= n
        parts += [(size << 3 | last).to_bytes(3, "little"),
                  view[off:off + size]]
    return b"".join(parts)


# ------------------------------------------------------------------ OCDBT
def _unwrap(blob: bytes, magic: int, what: str) -> bytes:
    """The body of an OCDBT manifest or node file, its header and CRC-32C
    checked and its zstd frame decoded."""
    if len(blob) < 18:
        raise ValueError(f"{what}: {len(blob)} bytes is too short")
    got, length = struct.unpack(">I", blob[:4])[0], struct.unpack(
        "<Q", blob[4:12])[0]
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    if length != len(blob):
        raise ValueError(f"{what}: header says {length} bytes, file has "
                         f"{len(blob)}")
    crc = struct.unpack("<I", blob[-4:])[0]
    if native.crc32c(blob[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    cur = _Cursor(blob, what, 12)
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version}")
    body = blob[cur.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return native.zstd_decompress(body).tobytes()
    raise ValueError(f"{what}: unknown compression {compression}")


def _wrap(body: bytes, magic: int) -> bytes:
    """An OCDBT file of ``body``: zstd-framed, with header and CRC-32C."""
    frame = zstd_frame(body)
    head = struct.pack(">I", magic) + struct.pack(
        "<Q", 12 + 2 + len(frame) + 4) + _varint(0) + _varint(1)
    blob = head + frame
    return blob + struct.pack("<I", native.crc32c(blob))


def _read_files(cur: _Cursor) -> list[str]:
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    cur.varints(n)  # base-path lengths: the split does not change the path
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{cur.what}: bad data file table")
        prev = prev[:prefix[i]] + cur.take(suffix[i])
        out.append(prev.decode())
    return out


def _files_table(paths: list[str]) -> bytes:
    enc = [p.encode() for p in paths]
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(enc, enc[1:])]
    suffix = [len(e) - p for e, p in zip(enc, [0] + prefix)]
    return (_varint(len(enc)) + _varints(prefix) + _varints(suffix)
            + _varints([0] * len(enc))
            + b"".join(e[p:] for e, p in zip(enc, [0] + prefix)))


class OcdbtStore:
    """The newest version of an OCDBT database at ``root``: its keys, each
    value inline or ``(data file, offset, length)``."""

    def __init__(self, root: str):
        self.root = root
        what = os.path.join(root, "manifest.ocdbt")
        with open(what, "rb") as f:
            cur = _Cursor(_unwrap(f.read(), MANIFEST_MAGIC, what), what)
        cur.take(16)  # uuid
        kind = cur.varint()
        cur.varints(2)  # max inline value bytes, max decoded node bytes
        cur.byte()  # version tree arity log2
        if cur.varint() == 1:
            cur.take(4)  # zstd level
        if kind != 0:
            raise ValueError(f"{what}: manifest kind {kind} (numbered "
                             "manifests) is not read")
        files = _read_files(cur)
        n = cur.varint()
        if n == 0:
            raise ValueError(f"{what}: no version inline in the manifest")
        gens = cur.varints(n)
        heights = list(cur.take(n))
        fid, off, length = cur.varints(n), cur.varints(n), cur.varints(n)
        newest = max(range(n), key=gens.__getitem__)
        self.values: dict[bytes, Any] = {}
        if off[newest] != NO_NODE:
            self._node(files[fid[newest]], off[newest], length[newest], b"",
                       heights[newest])

    def _node(self, path: str, offset: int, length: int, prefix: bytes,
              height: int) -> None:
        what = f"{os.path.join(self.root, path)}@{offset}"
        cur = _Cursor(_unwrap(self._bytes(path, offset, length), NODE_MAGIC,
                              what), what)
        if cur.byte() != height:
            raise ValueError(f"{what}: node height differs from its parent's "
                             "reference")
        files = _read_files(cur)
        n = cur.varint()
        shared = [0] + cur.varints(n - 1) if n else []
        lens = cur.varints(n)
        common = cur.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            prev = prev[:shared[i]] + cur.take(lens[i])
            keys.append(prev)
        if height:
            fid, off, size = cur.varints(n), cur.varints(n), cur.varints(n)
            for i in range(n):
                self._node(files[fid[i]], off[i], size[i],
                           prefix + keys[i][:common[i]], height - 1)
            return
        sizes, kinds = cur.varints(n), cur.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        fid, off = cur.varints(len(indirect)), cur.varints(len(indirect))
        refs = dict(zip(indirect, zip(fid, off)))
        for i in range(n):
            if kinds[i] == 0:
                self.values[prefix + keys[i]] = cur.take(sizes[i])
            elif kinds[i] == 1:
                f, o = refs[i]
                self.values[prefix + keys[i]] = (files[f], o, sizes[i])
            else:
                raise ValueError(f"{what}: value kind {kinds[i]}")
        if cur.pos != len(cur.buf):
            raise ValueError(f"{what}: {len(cur.buf) - cur.pos} bytes after "
                             "the leaf's values")

    def _bytes(self, path: str, offset: int, length: int) -> bytes:
        full = os.path.join(self.root, path)
        with open(full, "rb") as f:
            f.seek(offset)
            out = f.read(length)
        if len(out) != length:
            raise ValueError(f"{full}: {length} bytes at {offset} run past "
                             "the file's end")
        return out

    def get(self, key: str) -> Optional[bytes]:
        v = self.values.get(key.encode())
        if isinstance(v, tuple):
            return self._bytes(*v)
        return v


def _write_ocdbt(root: str, values: dict[bytes, bytes]) -> None:
    """A new OCDBT database at ``root`` holding ``values``: one data file
    with the values over ``MAX_INLINE_VALUE_BYTES`` and then the one leaf
    node, and the manifest of that single version."""
    data_name = f"d/{uuid.uuid4().hex}"
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    keys = sorted(values)
    shared = [len(os.path.commonprefix([a, b])) for a, b in zip(keys,
                                                                keys[1:])]
    indirect, inline, offsets, pos = [], [], [], 0
    with open(os.path.join(root, data_name), "wb") as f:
        for k in keys:
            v = values[k]
            if len(v) > MAX_INLINE_VALUE_BYTES:
                indirect.append(k)
                offsets.append(pos)
                f.write(v)
                pos += len(v)
            else:
                inline.append(v)
        node = _wrap(b"".join([
            b"\0", _files_table([data_name] if indirect else []),
            _varint(len(keys)), _varints(shared),
            _varints(len(k) - s for k, s in zip(keys, [0] + shared)),
            b"".join(k[s:] for k, s in zip(keys, [0] + shared)),
            _varints(len(values[k]) for k in keys),
            _varints(int(len(values[k]) > MAX_INLINE_VALUE_BYTES)
                     for k in keys),
            _varints([0] * len(indirect)), _varints(offsets),
            *inline]), NODE_MAGIC)
        f.write(node)
    manifest = b"".join([
        uuid.uuid4().bytes, _varint(0), _varint(MAX_INLINE_VALUE_BYTES),
        _varint(MAX_DECODED_NODE_BYTES), bytes([VERSION_TREE_ARITY_LOG2]),
        _varint(1), struct.pack("<i", 0), _files_table([data_name]),
        _varint(1), _varint(1), b"\0", _varint(0), _varint(pos),
        _varint(len(node)), _varint(len(keys)), _varint(len(node)),
        _varint(pos), struct.pack("<Q", time.time_ns()), _varint(0)])
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(_wrap(manifest, MANIFEST_MAGIC))


# ---------------------------------------------------------------- zarr v2
def _zarr_dtype(spec) -> np.dtype:
    """The numpy dtype a zarr v2 ``dtype`` stores (uint16 for bfloat16)."""
    if spec == "bfloat16":
        return np.dtype("<u2")
    if not isinstance(spec, str):
        raise ValueError(f"zarr dtype {spec!r} (structured) is not read")
    return np.dtype(spec)


def _zarr_spec(dtype) -> str:
    if dtype == torch.bfloat16:
        return "bfloat16"
    return np.dtype(dtype).str


def _region(index, shape: tuple) -> tuple[list[tuple[int, int]], list[int]]:
    """(start, stop) per dim of a basic index (ints, unit-step slices,
    one Ellipsis), and the dims that ints drop."""
    if not isinstance(index, tuple):
        index = (index,)
    if index.count(Ellipsis) > 1:
        raise IndexError("an index can only have a single ellipsis")
    if Ellipsis in index:
        e = index.index(Ellipsis)
        index = (index[:e] + (slice(None),) * (len(shape) - len(index) + 1)
                 + index[e + 1:])
    if len(index) > len(shape):
        raise IndexError(f"too many indices for a {len(shape)}-d array")
    index = index + (slice(None),) * (len(shape) - len(index))
    region, drop = [], []
    for d, (ix, n) in enumerate(zip(index, shape)):
        if isinstance(ix, slice):
            start, stop, step = ix.indices(n)
            if step != 1:
                raise IndexError("OrbaxArray slices take step 1")
            region.append((start, max(start, stop)))
        else:
            i = int(ix) + (n if int(ix) < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {ix} out of range for size {n}")
            region.append((i, i + 1))
            drop.append(d)
    return region, drop


class OrbaxArray:
    """A zarr v2 array of an ``OcdbtStore``, read on demand: ``a[...]`` or
    ``read(index)`` reads only the chunks the index covers; ``np.asarray``
    reads all. ``chunks_read`` (shared with the checkpoint) records the
    chunk keys read."""

    def __init__(self, store: OcdbtStore, name: str, chunks_read: set):
        raw = store.get(f"{name}/.zarray")
        if raw is None:
            raise ValueError(f"{store.root}: no zarr array {name}")
        meta = json.loads(raw)
        self.name, self.store, self.chunks_read = name, store, chunks_read
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}"
                             " (only zarr v2 is read)")
        if meta.get("filters"):
            raise ValueError(f"{name}: zarr filters {meta['filters']} are "
                             "not read")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise ValueError(f"{name}: zarr compressor {comp.get('id')!r} is "
                             "not read (zstd or none)")
        self.compressed = comp is not None
        self.order = meta.get("order", "C")
        if self.order not in ("C", "F"):
            raise ValueError(f"{name}: zarr order {self.order!r}")
        self.bf16 = meta["dtype"] == "bfloat16"
        self.stored = _zarr_dtype(meta["dtype"])
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.sep = meta.get("dimension_separator", ".")
        fill = meta.get("fill_value")
        self.fill = 0 if fill is None else (
            float(fill) if isinstance(fill, str) else fill)

    def _key(self, idx: tuple) -> str:
        return (f"{self.name}/{self.sep.join(map(str, idx))}" if idx
                else f"{self.name}/0")

    def _grid(self, region) -> itertools.product:
        """The chunk indices that ``region`` ((start, stop) a dim) covers."""
        return itertools.product(*[
            range(a // c, (b - 1) // c + 1) if b > a else range(0)
            for (a, b), c in zip(region, self.chunks)])

    def chunk_keys(self, index=()) -> list[str]:
        """The keys of the chunks that ``read(index)`` reads."""
        return [self._key(idx) for idx in
                self._grid(_region(index, self.shape)[0])]

    def _chunk(self, idx: tuple) -> np.ndarray:
        key = self._key(idx)
        raw = self.store.get(key)
        self.chunks_read.add(key)
        n = int(np.prod(self.chunks, dtype=np.int64))
        if raw is None:
            return np.full(self.chunks, self.fill, self.stored)
        data = (native.zstd_decompress(raw, n * self.stored.itemsize)
                if self.compressed else np.frombuffer(raw, np.uint8))
        if data.size != n * self.stored.itemsize:
            raise ValueError(f"{key}: {data.size} bytes, a chunk of "
                             f"{self.chunks} {self.stored} needs "
                             f"{n * self.stored.itemsize}")
        return data.view(self.stored).reshape(self.chunks, order=self.order)

    def read(self, index=()):
        """The values at ``index`` (a basic index): numpy in native byte
        order, or a ``torch.bfloat16`` tensor for a bfloat16 array."""
        region, drop = _region(index, self.shape)
        out = np.empty([b - a for a, b in region],
                       self.stored.newbyteorder("="))
        for idx in self._grid(region):
            chunk = self._chunk(idx)
            src, dst = [], []
            for (a, b), i, c in zip(region, idx, self.chunks):
                lo, hi = max(a, i * c), min(b, (i + 1) * c)
                src.append(slice(lo - i * c, hi - i * c))
                dst.append(slice(lo - a, hi - a))
            out[tuple(dst)] = chunk[tuple(src)]
        out = out.reshape([s for d, s in enumerate(out.shape)
                           if d not in drop])
        return torch.from_numpy(out).view(torch.bfloat16) if self.bf16 else out

    __getitem__ = read

    def __array__(self, dtype=None, copy=None):
        if self.bf16:
            raise TypeError(f"{self.name} is bfloat16, which numpy does not "
                            "hold; read() gives a torch tensor")
        out = self.read()
        return out if dtype is None else out.astype(dtype)

    def __int__(self) -> int:
        return int(self.read().item())

    def __float__(self) -> float:
        return float(self.read().item())


# ---------------------------------------------------------------- orbax
class OrbaxCheckpoint:
    """An orbax ``StandardCheckpointer`` directory: ``tree()`` is its item
    (``{"epoch", "state"}`` for ``save_orbax``) with ``OrbaxArray`` leaves
    (scalars read), ``chunks_read`` the chunk keys read so far."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        with open(os.path.join(self.path, "_METADATA")) as f:
            meta = json.load(f)
        if "tree_metadata" not in meta:
            raise ValueError(f"{self.path}/_METADATA has no tree_metadata "
                             "(orbax before 0.6 is not read)")
        if not meta.get("use_ocdbt", True):
            raise ValueError(f"{self.path}: a checkpoint without OCDBT is "
                             "not read")
        if meta.get("use_zarr3"):
            raise ValueError(f"{self.path}: zarr v3 arrays are not read")
        self.meta = meta["tree_metadata"]
        self.store = OcdbtStore(self.path)
        self.chunks_read: set[str] = set()

    def tree(self) -> dict:
        out: dict = {}
        for path, entry in self.meta.items():
            keys = [str(k["key"]) for k in entry["key_metadata"]]
            value = entry["value_metadata"]
            kind = value.get("value_type")
            if kind in ARRAY_TYPES or kind == "scalar":
                leaf = OrbaxArray(self.store, ".".join(keys),
                                  self.chunks_read)
                if kind == "scalar":
                    leaf = leaf.read().item()
            elif value.get("skip_deserialize"):
                leaf = {}  # an empty node: optax's EmptyState, MaskedNode
            else:
                raise ValueError(f"{path}: orbax value type {kind!r} is not "
                                 "read")
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = leaf
        return out


def _materialize(tree):
    if isinstance(tree, dict):
        return {k: _materialize(v) for k, v in tree.items()}
    return tree.read() if isinstance(tree, OrbaxArray) else tree


def load_orbax(path: str, target=None) -> dict:
    """Restore ``save_orbax``'s (either package's) ``{"epoch", "state"}``;
    with ``target`` its ``state`` is loaded into it (``target.load_tree``,
    which reads the leaves it needs, as ``load_checkpoint``) and replaced
    by it."""
    ckpt = OrbaxCheckpoint(path)
    payload = ckpt.tree()
    if target is None:
        return _materialize(payload)
    target.load_tree(payload["state"])
    payload["state"] = target
    return payload


def _host(tree):
    """Nested dicts of numpy arrays, Python scalars and bfloat16 tensors
    (CPU) of a state tree, a ``TrainState`` through its ``tree()``."""
    if hasattr(tree, "tree"):
        tree = tree.tree()
    if isinstance(tree, dict):
        return {str(k): _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t.contiguous() if t.dtype == torch.bfloat16 else t.numpy()
    return tree


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _is_sequence(node) -> bool:
    """A dict keyed "0".."n-1": flax's state dict of a tuple or list."""
    return (isinstance(node, dict) and bool(node)
            and list(node) == [str(i) for i in range(len(node))])


def _key_types(tree: dict, keys: tuple) -> list[int]:
    """Orbax's key_type of each key of a path: ``SEQUENCE`` under a
    sequence, else ``DICT_KEY``."""
    out = []
    for k in keys:
        out.append(SEQUENCE if _is_sequence(tree) else DICT_KEY)
        tree = tree[k]
    return out


def _zarr_values(name: str, arr, chunks: tuple) -> dict[bytes, bytes]:
    """The OCDBT values of one zarr v2 array: its ``.zarray`` and a zstd
    frame of each C-order chunk (edge chunks padded with zeros)."""
    spec = _zarr_spec(arr.dtype)
    if spec == "bfloat16":
        arr = arr.view(torch.int16).numpy().view("<u2")
    else:
        arr = np.asarray(arr)
        arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    meta = {"chunks": list(chunks), "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": spec, "fill_value": None,
            "filters": None, "order": "C", "shape": list(arr.shape),
            "zarr_format": 2}
    out = {f"{name}/.zarray".encode(): json.dumps(
        meta, sort_keys=True, separators=(",", ":")).encode()}
    grid = [range(-(-n // c)) if c else range(1)
            for n, c in zip(arr.shape, chunks)]
    for idx in itertools.product(*grid):
        part = arr[tuple(slice(i * c, (i + 1) * c)
                         for i, c in zip(idx, chunks))]
        if part.shape != tuple(chunks):
            full = np.zeros(chunks, arr.dtype)
            full[tuple(slice(0, s) for s in part.shape)] = part
            part = full
        key = ".".join(map(str, idx)) if idx else "0"
        out[f"{name}/{key}".encode()] = zstd_frame(
            np.ascontiguousarray(part).view(np.uint8).reshape(-1))
    return out


def _chunks(path: tuple, shape: tuple, split) -> tuple:
    """One chunk, or under ``split`` (n_model, paths) one chunk per
    'model' slice along the last axis of a leaf whose path ends with a
    split param's flax path."""
    if split is not None and shape:
        n, paths = split
        if shape[-1] % n == 0 and any(path[-len(p):] == p for p in paths):
            return shape[:-1] + (shape[-1] // n,)
    return shape


def save_orbax(path: str, state, epoch: int = 0) -> str:
    """Write ``{"epoch": epoch, "state": state}`` as orbax's
    ``StandardCheckpointer`` does (replacing a checkpoint at ``path``).
    ``state``: nested dicts of arrays, tensors and scalars, or an object
    with ``tree()`` (``TrainState``; under a mesh every rank calls this,
    rank 0 writes, and the state's ``model_shards()`` sets the chunks).
    Returns the absolute path."""
    path = os.path.abspath(path)
    split = getattr(state, "model_shards", lambda: None)()
    item = {"epoch": int(epoch), "state": _host(state)}
    if not dist.is_initialized() or dist.get_rank() == 0:
        _write(path, item, split)
    if dist.is_initialized():
        dist.barrier()
    return path


def _write(path: str, item: dict, split) -> None:
    start = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tree_meta, values = {}, {}
    for keys, leaf in _leaves(item):
        kinds = _key_types(item, keys)
        entry = {"key_metadata": [{"key": k, "key_type": t}
                                  for k, t in zip(keys, kinds)]}
        if isinstance(leaf, dict):
            entry["value_metadata"] = {
                "value_type": "None" if kinds[-1] == SEQUENCE else "Dict",
                "skip_deserialize": True}
        else:
            scalar = isinstance(leaf, (bool, int, float, np.generic))
            if scalar:
                leaf = np.asarray(leaf)
            if not isinstance(leaf, (np.ndarray, torch.Tensor)):
                raise TypeError(f"{keys}: a {type(leaf).__name__} leaf is not "
                                "saved")
            entry["value_metadata"] = {
                "value_type": "scalar" if scalar else "np.ndarray",
                "skip_deserialize": False}
            values.update(_zarr_values(".".join(keys), leaf, _chunks(
                keys, tuple(leaf.shape), split)))
        tree_meta[repr(tuple(keys))] = entry
    _write_ocdbt(tmp, values)
    files = {
        "_METADATA": {"tree_metadata": tree_meta, "use_ocdbt": True,
                      "use_zarr3": False,
                      "store_array_data_equal_to_fill_value": True,
                      "custom_metadata": None},
        "_sharding": {},
        "_CHECKPOINT_METADATA": {
            "item_handlers": HANDLER, "metrics": {},
            "performance_metrics": {}, "init_timestamp_nsecs": start,
            "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}}}
    for name, obj in files.items():
        with open(os.path.join(tmp, name), "w") as f:
            json.dump(obj, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
