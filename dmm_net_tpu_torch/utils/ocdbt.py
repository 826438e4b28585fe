"""Reader of tensorstore's OCDBT key-value stores, the format under each
item of an orbax checkpoint step (``<dir>/<step>/state/``).

The JAX package writes its TrainState through orbax, which writes each
array as a zarr array whose keys (``<name>/.zarray``, ``<name>/0.0``, ...)
live in one OCDBT store; tensorstore reads them back there. This module is
the port's reader of that store: it takes the store's directory and
returns the value of a key as bytes. It writes nothing.

The store, as tensorstore 0.1 writes it (format version 0):

* ``manifest.ocdbt``: the config (uuid, manifest kind, the inline-value
  and node-size limits, the version tree's arity, the node compression),
  a data file table, the newest versions inline and references to
  version tree nodes holding the older ones. Each version names the root
  of its B-tree: a height, a location (data file, offset, length) and the
  tree's statistics. The newest generation, the last of the inline ones,
  is the store's content; older generations are not read.
* Data files (``d/<hash>``, and ``ocdbt.process_<i>/d/<hash>`` for the
  per-process stores a multi-process write merges): B-tree nodes, version
  tree nodes and values, each node at an (offset, length) of its file.
* Every manifest and node is framed alike: a big-endian magic number
  (manifest ``0cdb3a2a``, B-tree node ``0cdb20de``), its total length (uint64, little-endian), the format
  version and the body's compression (varints; 0 none, 1 zstd), the body,
  and a CRC-32C of everything before it (uint32, little-endian).
* Bodies are column-wise: a field is stored for every entry before the
  next field. Integers are LEB128 varints; heights are one byte; commit
  times uint64; the zstd level int32, little-endian. A data file table
  lists paths, each sharing a prefix with the one before it. A missing
  location (an empty tree's root) has offset and length 2^64 - 1.
* B-tree leaves hold keys (prefix-compressed against the previous key)
  with values either inline or by reference (data file, offset; the
  length is stored for both). Interior nodes hold, per child, its first
  key, the length of the prefix every key under it shares (stripped from
  the keys inside it), its location and statistics.

Anything else (another format version, a node compression other than
zstd, numbered manifests, a value kind other than inline or by reference,
a bad checksum or a body with bytes left over) is refused by name.
"""

from __future__ import annotations

import bisect
import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

from dmm_net_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_KINDS = {MANIFEST_MAGIC: "manifest", BTREE_MAGIC: "B-tree node"}
_MISSING = (1 << 64) - 1
_MANIFEST_KINDS = {0: "single", 1: "numbered"}
_INLINE, _INDIRECT = 0, 1


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the format checksums its manifests and
    nodes."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Reads a body front to back; ``what`` names it in errors."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"ocdbt: {self.what} is truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift >= 64:
                raise ValueError(f"ocdbt: {self.what} has a varint over 64 "
                                 "bits")
        if out >= 1 << 64:
            raise ValueError(f"ocdbt: {self.what} has a varint over 64 bits")
        return out

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8s(self, n: int) -> List[int]:
        return list(self.take(n))

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"ocdbt: {self.what} has "
                             f"{len(self.data) - self.pos} bytes left over")


def _unframe(raw: bytes, magic: int, what: str) -> _Cursor:
    """Check a manifest's or node's frame (magic, length, checksum, format
    version, compression); a cursor over its decoded body."""
    kind = _KINDS[magic]
    if len(raw) < 18 or struct.unpack(">I", raw[:4])[0] != magic:
        found = raw[:4].hex() if len(raw) >= 4 else f"{len(raw)} bytes"
        raise ValueError(f"ocdbt: {what} is not an OCDBT {kind} (magic "
                         f"{found}, expected {magic:08x})")
    length = struct.unpack("<Q", raw[4:12])[0]
    if length != len(raw):
        raise ValueError(f"ocdbt: {what} records {length} bytes, holds "
                         f"{len(raw)}")
    if crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise ValueError(f"ocdbt: {what} fails its CRC-32C checksum")
    head = _Cursor(raw[12:-4], what)
    version = head.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {what} is in format version {version}; "
                         "only version 0 is decoded")
    method = head.varint()
    body = raw[12 + head.pos:-4]
    if method == 1:
        body = zstd.decompress(body)
    elif method != 0:
        raise ValueError(f"ocdbt: {what} uses compression {method}; only "
                         "none (0) and zstd (1) are decoded")
    return _Cursor(body, f"{what} ({kind})")


def _data_files(c: _Cursor) -> List[str]:
    """A data file table: each path shares a prefix with the one before."""
    n = c.varint()
    shared = [0] + c.varints(n - 1) if n else []
    lengths = c.varints(n)
    base = c.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise ValueError(f"ocdbt: {c.what}: data file {i} shares more "
                             "than the previous path")
        path = prev[:shared[i]] + c.take(lengths[i])
        if base[i] > len(path):
            raise ValueError(f"ocdbt: {c.what}: data file {i}'s base path "
                             "is longer than its path")
        paths.append(path.decode())
        prev = path
    return paths


@dataclass(frozen=True)
class Location:
    """A byte range of a data file."""
    path: str
    offset: int
    length: int


def _locations(c: _Cursor, files: List[str], n: int) -> List[Optional[Location]]:
    ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
    out: List[Optional[Location]] = []
    for i, o, n_ in zip(ids, offsets, lengths):
        if i >= len(files):
            raise ValueError(f"ocdbt: {c.what}: data file {i} of "
                             f"{len(files)}")
        out.append(None if o == n_ == _MISSING else Location(files[i], o, n_))
    return out


@dataclass(frozen=True)
class Version:
    """One generation of the store: its B-tree root and statistics."""
    generation: int
    root_height: int
    root: Optional[Location]          # None: the tree is empty
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time: int                  # ns since the epoch


def _versions(c: _Cursor, files: List[str]) -> List[Version]:
    n = c.varint()
    gens, heights = c.varints(n), c.u8s(n)
    roots = _locations(c, files, n)
    keys, tree, indirect = c.varints(n), c.varints(n), c.varints(n)
    times = [c.u64() for _ in range(n)]
    return [Version(*v) for v in zip(gens, heights, roots, keys, tree,
                                     indirect, times)]


def _skip_version_refs(c: _Cursor, files: List[str]) -> None:
    """The manifest's references to version tree nodes (older generations,
    which are not read): consumed and checked, not kept."""
    n = c.varint()
    c.varints(n)                                       # newest generation under each
    if any(loc is None for loc in _locations(c, files, n)):
        raise ValueError(f"ocdbt: {c.what}: a version tree node has no "
                         "location")
    c.varints(n)                                       # generations under each
    c.take(8 * n)                                      # commit times
    c.take(n)                                          # heights


@dataclass
class _Leaf:
    keys: List[bytes]
    values: List[Union[bytes, Location]]


@dataclass
class _Interior:
    keys: List[bytes]
    prefix_lengths: List[int]
    children: List[Location]


class OcdbtStore:
    """The OCDBT store under ``root`` (a directory holding
    ``manifest.ocdbt``) at its newest generation. ``read(key)`` fetches one
    value, descending the B-tree from its root. Decoded nodes are kept, so
    many reads decode each node once."""

    def __init__(self, root: str):
        self.root = root
        c = _unframe(self._file("manifest.ocdbt"), MANIFEST_MAGIC,
                     os.path.join(root, "manifest.ocdbt"))
        c.take(16)                                     # the store's uuid
        kind = c.varint()
        if kind != 0:
            raise ValueError(f"ocdbt: {root}: manifest kind {kind} "
                             f"({_MANIFEST_KINDS.get(kind, 'unknown')}); only "
                             "single-file manifests (0) are decoded")
        c.varint()                                     # max inline value bytes
        c.varint()                                     # max decoded node bytes
        c.u8()                                         # version tree arity, log2
        method = c.varint()
        if method not in (0, 1):
            raise ValueError(f"ocdbt: {root}: node compression {method}; "
                             "only none (0) and zstd (1) are decoded")
        if method == 1:
            c.take(4)                                  # zstd level (int32)
        files = _data_files(c)
        inline = _versions(c, files)
        _skip_version_refs(c, files)
        c.end()
        self._nodes: Dict[Location, Union[_Leaf, _Interior]] = {}
        if not inline:
            raise ValueError(f"ocdbt: {root}: the manifest holds no version")
        self.version = inline[-1]

    def _file(self, rel: str, offset: int = 0,
              length: Optional[int] = None) -> bytes:
        if os.path.isabs(rel) or ".." in rel.split("/"):
            raise ValueError(f"ocdbt: {self.root}: data file path {rel!r} "
                             "leaves the store")
        with open(os.path.join(self.root, rel), "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
        if length is not None and len(data) != length:
            raise ValueError(f"ocdbt: {self.root}/{rel}: {length} bytes at "
                             f"{offset} run past its end")
        return data

    def _read(self, loc: Location, magic: int) -> _Cursor:
        return _unframe(self._file(loc.path, loc.offset, loc.length), magic,
                        f"{self.root}/{loc.path}@{loc.offset}")

    # -- the B-tree ----------------------------------------------------------

    def _node(self, loc: Location, height: int) -> Union[_Leaf, _Interior]:
        node = self._nodes.get(loc)
        if node is not None:
            return node
        c = self._read(loc, BTREE_MAGIC)
        h = c.u8()
        if h != height:
            raise ValueError(f"ocdbt: {c.what} has height {h}, its parent "
                             f"says {height}")
        files = _data_files(c)
        n = c.varint()
        shared = [0] + c.varints(n - 1) if n else []
        lengths = c.varints(n)
        prefix_lengths = c.varints(n) if h else None
        keys, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                raise ValueError(f"ocdbt: {c.what}: key {i} shares more than "
                                 "the previous key")
            prev = prev[:shared[i]] + c.take(lengths[i])
            keys.append(prev)
        if h:
            children = _locations(c, files, n)
            for _ in range(3):                         # the subtrees' statistics
                c.varints(n)
            c.end()
            if any(loc is None for loc in children):
                raise ValueError(f"ocdbt: {c.what}: a child has no location")
            node = _Interior(keys, prefix_lengths, children)
        else:
            sizes, kinds = c.varints(n), c.varints(n)
            bad = sorted(set(kinds) - {_INLINE, _INDIRECT})
            if bad:
                raise ValueError(f"ocdbt: {c.what}: value kind {bad[0]}; only "
                                 "inline (0) and by reference (1) are decoded")
            indirect = [i for i, k in enumerate(kinds) if k == _INDIRECT]
            ids = c.varints(len(indirect))
            offsets = c.varints(len(indirect))
            values: List[Union[bytes, Location]] = [b""] * n
            for i, f, o in zip(indirect, ids, offsets):
                if f >= len(files):
                    raise ValueError(f"ocdbt: {c.what}: data file {f} of "
                                     f"{len(files)}")
                values[i] = Location(files[f], o, sizes[i])
            for i, k in enumerate(kinds):
                if k == _INLINE:
                    values[i] = c.take(sizes[i])
            c.end()
            node = _Leaf(keys, values)
        self._nodes[loc] = node
        return node

    def _value(self, v: Union[bytes, Location]) -> bytes:
        return v if isinstance(v, bytes) else self._file(v.path, v.offset,
                                                         v.length)

    def read(self, key: str) -> Optional[bytes]:
        """The value of ``key``, or None where the store has no such key."""
        if self.version.root is None:
            return None
        rest = key.encode()
        loc, height = self.version.root, self.version.root_height
        while True:
            node = self._node(loc, height)
            if isinstance(node, _Leaf):
                i = bisect.bisect_left(node.keys, rest)
                if i < len(node.keys) and node.keys[i] == rest:
                    return self._value(node.values[i])
                return None
            i = bisect.bisect_right(node.keys, rest) - 1
            if i < 0:
                return None
            shared = node.keys[i][:node.prefix_lengths[i]]
            if not rest.startswith(shared):
                return None
            rest = rest[len(shared):]
            loc, height = node.children[i], height - 1
