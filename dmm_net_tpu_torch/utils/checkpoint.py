"""Checkpoints: the port's own (``Checkpointer``, torch files) and the JAX
package's flax msgpack blobs, read without flax or msgpack.

``Checkpointer`` writes ``<dir>/step_<n>.pt``: a ``torch.save`` dict of the
step, the model's state_dict (float32 parameters and BN running
statistics), the optimizer's state with its schedule, and the config dict
(``Config.to_dict()``, the same dict a msgpack blob carries). Each file is
written to a temporary name and renamed, so a crash never leaves a torn
checkpoint; the last ``keep`` are kept. ``load_checkpoint`` reads either
kind for serving.

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
``msgpack_serialize`` writes str-keyed dicts of numeric arrays as flax's
``msgpack_serialize`` does, byte for byte: the detector's ``{"params",
"batch_stats"}`` files that train_proposal_torch.py saves are read by both
packages.
"""

from __future__ import annotations

import os
import re
import struct
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

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


def _length(n: int, fix: Optional[int], fix_max: int, codes) -> bytes:
    """A msgpack length header: the fix form up to ``fix_max``, else the
    smallest of ``codes`` (8-, 16- and 32-bit lengths; None where the type
    has no such form)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, limit in zip(codes, "BHI", (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return struct.pack(">B" + fmt, code, n)
    raise ValueError(f"msgpack: object of length {n} is too large")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _length(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + data


def _uint(v: int) -> bytes:
    """The smallest msgpack form of a non-negative int."""
    if v <= 0x7F:
        return bytes([v])
    for code, fmt, limit in ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16),
                             (0xCE, "I", 1 << 32), (0xCF, "Q", 1 << 64)):
        if v < limit:
            return struct.pack(">B" + fmt, code, v)
    raise OverflowError(f"msgpack: int {v} out of range")


# flax splits arrays above this many bytes into chunks; the writer does not
_MAX_CHUNK_BYTES = 2 ** 30


def _ndarray_ext(arr: np.ndarray) -> bytes:
    """flax's ndarray extension (type 1): the msgpack triple (shape, dtype
    name, raw C-order bytes), under a fixext header where the payload is 1,
    2, 4, 8 or 16 bytes long."""
    if arr.dtype.kind not in "biuf" or arr.nbytes > _MAX_CHUNK_BYTES:
        raise ValueError(f"msgpack: cannot write a {arr.dtype} array of "
                         f"{arr.nbytes} bytes")
    raw = arr.tobytes("C")
    data = b"".join([b"\x93", _length(arr.ndim, 0x90, 15, (None, 0xDC, 0xDD)),
                     *(_uint(int(d)) for d in arr.shape), _str(arr.dtype.name),
                     _length(len(raw), None, 0, (0xC4, 0xC5, 0xC6)), raw])
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(data))
    head = bytes([fix]) if fix else _length(len(data), None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", _EXT_NDARRAY) + data


def _pack(tree, out: list) -> None:
    if type(tree) is dict:
        out.append(_length(len(tree), 0x80, 15, (None, 0xDE, 0xDF)))
        for k in sorted(tree):        # flax's tree_map copy sorts the keys
            if type(k) is not str:
                raise TypeError(f"msgpack: key {k!r} is not a str")
            out.append(_str(k))
            _pack(tree[k], out)
    elif isinstance(tree, np.ndarray):
        out.append(_ndarray_ext(tree))
    else:
        raise TypeError(f"msgpack: cannot write {type(tree).__name__}")


def msgpack_serialize(tree) -> bytes:
    """Encode nested str-keyed dicts of numeric numpy arrays (the
    ``{"params", "batch_stats"}`` trees of ``weights.to_flax_variables``)
    byte for byte as ``flax.serialization.msgpack_serialize`` does; both
    ``msgpack_restore`` and flax read it. Anything else raises."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


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
    directory is refused (the port writes torch checkpoints: Checkpointer)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path}: orbax checkpoint directories are not supported by the "
            "port (ROADMAP.md §A, item 9); pass a flax msgpack blob or a "
            "checkpoint written by the port's Checkpointer")
    with open(path, "rb") as f:
        blob = msgpack_restore(f.read())
    if not isinstance(blob, dict) or "variables" not in blob:
        raise ValueError(f"{path}: not a DMM msgpack checkpoint (expected "
                         "{'config', 'variables'})")
    cfg = config_from_dict(blob["config"]) if "config" in blob else None
    return cfg, blob["variables"]


_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class Checkpointer:
    """Keep-last-``keep`` torch checkpoints of a TrainState in ``directory``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def _steps(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _STEP_FILE.match(f)))

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, state, step: Optional[int] = None) -> str:
        """Write ``state`` (a train/loop.TrainState) atomically; returns the
        file's path."""
        step = state.step if step is None else step
        os.makedirs(self.directory, exist_ok=True)
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save({"step": step, "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "config": state.model.config.to_dict()}, tmp)
        os.replace(tmp, path)
        for old in self._steps()[:-self.keep]:
            os.remove(self.path(old))
        return path

    def restore(self, state, step: Optional[int] = None):
        """Load the checkpoint at ``step`` (the latest by default) into
        ``state`` in place; returns it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        ckpt = torch.load(self.path(step), map_location=state.model.device,
                          weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        return state


def load_checkpoint(path: str) -> Tuple[Optional[Config], Dict[str, Any]]:
    """A checkpoint for serving: returns (its config or None, and either
    ``{"state_dict": ...}`` for the port's torch checkpoints (a file, or a
    Checkpointer directory, whose latest step is taken) or
    ``{"variables": ...}`` for a JAX-package msgpack blob)."""
    if os.path.isdir(path):
        step = Checkpointer(path).latest_step()
        if step is None:
            return load_msgpack_ckpt(path)     # refuses other directories
        path = Checkpointer(path).path(step)
    if zipfile.is_zipfile(path):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return config_from_dict(ckpt["config"]), {"state_dict": ckpt["model"]}
    cfg, variables = load_msgpack_ckpt(path)
    return cfg, {"variables": variables}
