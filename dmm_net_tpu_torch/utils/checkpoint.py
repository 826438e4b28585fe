"""Read the JAX package's flax msgpack checkpoints without flax or msgpack.

A checkpoint blob is ``{"config": Config.to_dict(), "variables": {"params",
"batch_stats"}}`` serialised by ``flax.serialization.msgpack_serialize``:
msgpack maps, arrays, str, bin, ints, floats, bool and nil, with three ext
types for numpy values (code 1: an ndarray packed as the msgpack triple
(shape, dtype name, raw C-order bytes); 2: a complex as (real, imag); 3: a
numpy scalar packed like an ndarray). Arrays over 1 GiB are split by flax
into ``{"__msgpack_chunked_array__": True, "shape", "chunks"}`` maps.

``load_msgpack_ckpt`` returns the same tree as ``msgpack_restore``: dicts
with str keys, lists, and read-only numpy leaves of the stored dtype
(bfloat16 leaves, which numpy cannot hold, come back as float32, exactly).
"""

from __future__ import annotations

import os
import struct
from typing import Any, Optional, Tuple

import numpy as np

from dmm_net_tpu_torch.config import Config, config_from_dict

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
# fixed-width scalars: type byte -> struct format
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# length-prefixed objects: type byte -> (kind, length format)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """msgpack decoder over a bytes-like buffer. ``raw``: str objects stay
    bytes (as flax decodes an ndarray's inner triple)."""

    def __init__(self, buf, raw: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self._unpack(_FIXED[b])
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return bytes(self._take(n))
            if kind == "str":
                return self._str(n)
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            return self._ext(n)
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def _str(self, n: int):
        data = bytes(self._take(n))
        return data if self.raw else data.decode("utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = struct.unpack(">b", self._take(1))[0]
        data = self._take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).read()
            return complex(re, im)
        raise ValueError(f"msgpack: unknown ext type {code}")


def _ndarray_from_bytes(data) -> np.ndarray:
    shape, dtype_name, buf = _Reader(data, raw=True).read()
    if dtype_name == b"bfloat16":     # upper half of a float32, exactly
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _unchunk(tree):
    """Reassemble flax's chunked oversized arrays, recursively."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """Decode a flax msgpack blob into nested dicts with numpy leaves."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes")
    return _unchunk(tree)


def load_msgpack_ckpt(path: str) -> Tuple[Optional[Config], dict]:
    """Load a checkpoint blob ``{"config", "variables"}``: returns (its
    config, or None when it carries none; the variables). An orbax checkpoint
    directory is refused: torch checkpoints come with training."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path}: orbax checkpoint directories are not supported by the "
            "port (ROADMAP.md §A, item 7); pass a flax msgpack blob")
    with open(path, "rb") as f:
        blob = msgpack_restore(f.read())
    if not isinstance(blob, dict) or "variables" not in blob:
        raise ValueError(f"{path}: not a DMM msgpack checkpoint (expected "
                         "{'config', 'variables'})")
    cfg = config_from_dict(blob["config"]) if "config" in blob else None
    return cfg, blob["variables"]
