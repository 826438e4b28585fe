"""Checkpoints: the port's own (``Checkpointer``, torch files) and the JAX
package's flax msgpack blobs, read without flax or msgpack.

``Checkpointer`` writes ``<dir>/step_<n>.pt``: a ``torch.save`` dict of the
step, the model's state_dict (float32 parameters and BN running
statistics), the optimizer's state with its schedule, and the config dict
(``Config.to_dict()``, the same dict a msgpack blob carries). Each file is
written to a temporary name and renamed, so a crash never leaves a torn
checkpoint; the last ``keep`` are kept. ``load_checkpoint`` reads either
kind for serving, and the orbax directories of the JAX package's train.py
(``<logdir>/ckpt/<step>/``: zarr v2 arrays in an OCDBT store, read by
``read_zarr`` over utils/ocdbt.py), of whose latest step it reads the
params alone; ``read_orbax_step`` returns a whole step for resuming.

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
``msgpack_serialize`` writes str-keyed dicts of numeric arrays, str, int,
float, bool, None and lists as flax's ``msgpack_serialize`` does, byte for
byte: the detector's ``{"params", "batch_stats"}`` files that
train_proposal_torch.py saves and the DMM's ``{"config", "variables"}``
blobs that examples/train_and_eval_synthetic_torch.py saves are read by
both packages.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
import re
import struct
import zipfile
from typing import Any, Collection, Dict, List, Optional, Tuple

import numpy as np
import torch

from dmm_net_tpu_torch.config import Config, config_from_dict
from dmm_net_tpu_torch.utils import zstd
from dmm_net_tpu_torch.utils.ocdbt import OcdbtStore

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


def _int(v: int) -> bytes:
    """The smallest msgpack form of an int."""
    if v >= 0:
        return _uint(v)
    if v >= -32:
        return struct.pack(">b", v)
    for code, fmt, bits in ((0xD0, "b", 7), (0xD1, "h", 15), (0xD2, "i", 31),
                            (0xD3, "q", 63)):
        if v >= -(1 << bits):
            return struct.pack(">B" + fmt, code, v)
    raise OverflowError(f"msgpack: int {v} out of range")


def _pack(tree, out: list) -> None:
    if type(tree) is dict:
        out.append(_length(len(tree), 0x80, 15, (None, 0xDE, 0xDF)))
        for k in sorted(tree):        # flax's tree_map copy sorts the keys
            if type(k) is not str:
                raise TypeError(f"msgpack: key {k!r} is not a str")
            out.append(_str(k))
            _pack(tree[k], out)
    elif type(tree) is list:
        out.append(_length(len(tree), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in tree:
            _pack(v, out)
    elif isinstance(tree, np.ndarray):
        out.append(_ndarray_ext(tree))
    elif tree is None:
        out.append(b"\xc0")
    elif type(tree) is bool:
        out.append(b"\xc3" if tree else b"\xc2")
    elif type(tree) is int:
        out.append(_int(tree))
    elif type(tree) is float:
        out.append(struct.pack(">Bd", 0xCB, tree))
    elif type(tree) is str:
        out.append(_str(tree))
    else:
        raise TypeError(f"msgpack: cannot write {type(tree).__name__}")


def msgpack_serialize(tree) -> bytes:
    """Encode nested str-keyed dicts and lists of numeric numpy arrays, str,
    int, float, bool and None (a ``{"config": Config.to_dict(),
    "variables": weights.to_flax_variables(model)}`` blob, or the variables
    alone) byte for byte as ``flax.serialization.msgpack_serialize`` does;
    both ``msgpack_restore`` and flax read it. Anything else (a tuple, a
    numpy scalar) raises."""
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
    config, or None when it carries none; the variables). A blob is a file:
    checkpoint directories (the port's, or orbax's) go to
    ``load_checkpoint``."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, not a flax msgpack blob; load_checkpoint "
            "reads the port's and orbax's checkpoint directories")
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


# -- orbax checkpoint directories (the JAX package's train.py) ---------------

# the zarr v2 dtypes orbax writes for the JAX package's TrainState -> (numpy
# dtype of the raw bytes, torch dtype); bfloat16, which numpy cannot hold,
# is read as its 16 bits and viewed by torch
_ZARR_DTYPES = {"<f4": (np.float32, torch.float32), "<i4": (np.int32, torch.int32),
                "<i8": (np.int64, torch.int64), "bfloat16": (np.int16, torch.bfloat16)}
_EMPTY_NODES = {"None": None, "Dict": {}, "Tuple": (), "List": []}
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
_DICT_KEY, _SEQUENCE_INDEX = 2, 1


def read_zarr(store: OcdbtStore, name: str) -> torch.Tensor:
    """The zarr v2 array ``name`` of an OCDBT store, as orbax writes one:
    ``<name>/.zarray`` and its zstd-compressed chunks ``<name>/<i>.<j>...``
    (``<name>/0`` for a scalar), assembled in C order; a chunk the store
    does not hold is refused, as orbax refuses it. Returns a CPU tensor of
    the stored dtype."""
    raw = store.read(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"zarr: no array {name!r} in {store.root}")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" \
            or meta.get("filters"):
        raise ValueError(f"zarr: {name}: only zarr v2 arrays in C order with "
                         f"no filters are read, not {meta}")
    if meta["dtype"] not in _ZARR_DTYPES:
        raise ValueError(f"zarr: {name}: dtype {meta['dtype']!r} is not read "
                         f"(only {', '.join(_ZARR_DTYPES)})")
    compressor = meta.get("compressor")
    if (compressor or {}).get("id") != "zstd":
        raise ValueError(f"zarr: {name}: compressor {compressor} is not read "
                         "(only zstd)")
    np_dtype, torch_dtype = _ZARR_DTYPES[meta["dtype"]]
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"zarr: {name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, np_dtype)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * out.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        data = store.read(key)
        if data is None:         # orbax reads with fill_missing_data_reads off
            raise ValueError(f"zarr: chunk {key} is missing from {store.root}")
        data = zstd.decompress(data, size=chunk_bytes)
        block = np.frombuffer(data, np_dtype).reshape(chunks)
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if torch_dtype is torch.bfloat16 else t


def orbax_steps(directory: str) -> List[int]:
    """The finished steps of an orbax CheckpointManager directory, as orbax
    finds them: subdirectories named by an integer that hold
    ``_CHECKPOINT_METADATA``. A save still running (or cut) writes under
    ``<step>.orbax-checkpoint-tmp-<n>``, which is not a step."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.isfile(
                      os.path.join(directory, d, "_CHECKPOINT_METADATA")))


def latest_orbax_step(directory: str) -> Optional[int]:
    steps = orbax_steps(directory)
    return steps[-1] if steps else None


def _insert(tree: dict, keys, value, where: str) -> None:
    """Place ``value`` at ``keys`` (orbax key metadata: dict keys and
    sequence indices) in a nested dict; sequences are dicts keyed by int
    until ``_sequences`` turns them into tuples."""
    node = tree
    for depth, k in enumerate(keys):
        kind, key = k["key_type"], k["key"]
        if kind == _SEQUENCE_INDEX:
            key = int(key)
        elif kind != _DICT_KEY:
            raise ValueError(f"orbax: {where}: key type {kind} (only dict "
                             "keys (2) and sequence indices (1) are read)")
        tag = "seq" if kind == _SEQUENCE_INDEX else "dict"
        if node.setdefault("__kind__", tag) != tag:
            raise ValueError(f"orbax: {where}: a node is both a dict and a "
                             "sequence")
        if depth == len(keys) - 1:
            if key in node:
                raise ValueError(f"orbax: {where} appears twice")
            node[key] = value
        else:
            node = node.setdefault(key, {})


def _sequences(node):
    if not isinstance(node, dict) or "__kind__" not in node:
        return node
    kind = node.pop("__kind__")
    children = {k: _sequences(v) for k, v in node.items()}
    if kind == "dict":
        return children
    if sorted(children) != list(range(len(children))):
        raise ValueError(f"orbax: sequence indices {sorted(children)} are "
                         "not 0..n-1")
    return tuple(children[i] for i in range(len(children)))


def read_orbax_state(item_dir: str,
                     keys: Optional[Collection[str]] = None) -> Any:
    """One StandardSave item of an orbax step (``<step>/state``): its tree
    rebuilt from ``_METADATA`` (dicts for dict keys, tuples for sequence
    indices; optax's NamedTuple states are recorded as dicts) with CPU
    tensors at the array leaves, Python numbers at scalar leaves and None,
    {}, (), [] where orbax recorded an empty node. With ``keys``, only the
    leaves under those top-level keys are read (serving reads "params")."""
    with open(os.path.join(item_dir, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3") or not meta.get("use_ocdbt", False):
        raise ValueError(f"orbax: {item_dir}: only OCDBT stores of zarr v2 "
                         "arrays are read (use_ocdbt true, use_zarr3 false)")
    store = OcdbtStore(item_dir)
    tree: dict = {}
    for where, leaf in meta["tree_metadata"].items():
        path = leaf["key_metadata"]
        if keys is not None and path[0]["key"] not in keys:
            continue
        vtype = leaf["value_metadata"]["value_type"]
        if vtype in _EMPTY_NODES:
            value = copy.copy(_EMPTY_NODES[vtype])
        elif vtype in _ARRAY_TYPES:
            value = read_zarr(store, ".".join(k["key"] for k in path))
            if vtype == "scalar":
                value = value.item()
        else:
            raise ValueError(f"orbax: {where}: value type {vtype!r} is not "
                             "read")
        _insert(tree, path, value, where)
    return _sequences(tree) if tree else {}


def read_orbax_step(directory: str, step: int,
                    keys: Optional[Collection[str]] = None) -> Dict[str, Any]:
    """Step ``step`` of an orbax CheckpointManager directory, as the JAX
    package's Checkpointer saves it: ``{"state": the TrainState tree (step,
    params, batch_stats, opt_state; those in ``keys`` alone where given),
    "extra": the JSON item or None}``."""
    step_dir = os.path.join(directory, str(step))
    if not os.path.isfile(os.path.join(step_dir, "_CHECKPOINT_METADATA")):
        raise FileNotFoundError(f"orbax: no finished step {step} under "
                                f"{directory}")
    extra = None
    extra_path = os.path.join(step_dir, "extra", "metadata")
    if os.path.isfile(extra_path):
        with open(extra_path) as f:
            extra = json.load(f)
    return {"state": read_orbax_state(os.path.join(step_dir, "state"), keys),
            "extra": extra}


def checkpoint_kind(directory: str) -> Optional[str]:
    """What a checkpoint directory holds: ``"torch"`` (the port's
    ``step_<n>.pt`` files), ``"orbax"`` (finished orbax steps) or None
    (neither, or no such directory). One that holds both is refused."""
    torch_steps = Checkpointer(directory).latest_step() is not None
    orbax = bool(orbax_steps(directory))
    if torch_steps and orbax:
        raise ValueError(f"{directory} holds both the port's step_<n>.pt "
                         "checkpoints and orbax step directories; keep one "
                         "kind per directory")
    return "torch" if torch_steps else "orbax" if orbax else None


def load_checkpoint(path: str) -> Tuple[Optional[Config], Dict[str, Any]]:
    """A checkpoint for serving: returns (its config or None, and one of
    ``{"state_dict": ...}`` for the port's torch checkpoints (a file, or a
    Checkpointer directory, whose latest step is taken), ``{"params": ...}``
    for an orbax directory of the JAX package's train.py (its latest step's
    params alone, as infer.py restores them; it carries no config) or
    ``{"variables": ...}`` for a JAX-package msgpack blob)."""
    if os.path.isdir(path):
        kind = checkpoint_kind(path)
        if kind is None:
            raise ValueError(f"{path} holds neither the port's step_<n>.pt "
                             "checkpoints nor finished orbax step directories")
        if kind == "orbax":
            step = latest_orbax_step(path)
            state = read_orbax_step(path, step, keys=("params",))["state"]
            if "params" not in state:
                raise ValueError(f"{path}: orbax step {step} holds no params")
            return None, {"params": state["params"]}
        path = Checkpointer(path).path(Checkpointer(path).latest_step())
    if zipfile.is_zipfile(path):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return config_from_dict(ckpt["config"]), {"state_dict": ckpt["model"]}
    cfg, variables = load_msgpack_ckpt(path)
    return cfg, {"variables": variables}
