"""COCO-style RLE mask codec, for the proposal cache on disk.

The JAX package's ops/rle.py: dicts {"size": [h, w], "counts": <compressed
bytes>} with COCO's LEB128-style char compression, so caches written by
either package (or by cocoapi) are read the same. Column-major ("F") order
throughout, as COCO.

Run lengths are encoded, decoded and intersected (IoU) by the C++ codec
``csrc/host/maskrle.cpp`` (built with g++ at first use,
``kernels/_build.host_library``) when it builds; the numpy functions
``*_plain`` beside it are the plain version, used when it does not, and
the oracle. Tests pin the plain version with ``_TRIED = True`` and
``_LIB = None``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_REASON: Optional[str] = None
_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.rle_encode.restype = ctypes.c_int
    lib.rle_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u32p, ctypes.c_int]
    lib.rle_decode.restype = ctypes.c_int
    lib.rle_decode.argtypes = [u32p, ctypes.c_int, u8p, ctypes.c_int]
    lib.rle_iou.restype = ctypes.c_double
    lib.rle_iou.argtypes = [u32p, ctypes.c_int, u32p, ctypes.c_int]
    return lib


def _native() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _REASON
    if _TRIED:
        return _LIB
    with _lock:
        if not _TRIED:
            from dmm_net_tpu_torch.kernels import _build
            try:
                _LIB = _bind(_build.host_library("maskrle"))
            except (RuntimeError, OSError, AttributeError) as e:
                _REASON = str(e)
            _TRIED = True
    return _LIB


def available() -> bool:
    """True when the C++ codec is built and loaded."""
    return _native() is not None


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def encode_counts(mask: np.ndarray) -> np.ndarray:
    """Binary mask (h, w) -> uint32 run lengths (column-major, starting with
    the zero run, possibly of length 0)."""
    lib = _native()
    if lib is None:
        return encode_counts_plain(mask)
    flat = np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F")
    out = np.zeros(flat.size + 2, np.uint32)
    n = lib.rle_encode(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       int(mask.shape[0]), int(mask.shape[1]), _u32(out),
                       out.size)
    return out[:n].copy()


def decode_counts(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint32 run lengths -> binary mask (h, w) uint8."""
    lib = _native()
    if lib is None:
        return decode_counts_plain(counts, h, w)
    counts = np.ascontiguousarray(counts, np.uint32)
    out = np.zeros(h * w, np.uint8)
    lib.rle_decode(_u32(counts), counts.size,
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size)
    return out.reshape((h, w), order="F")


def encode_counts_plain(mask: np.ndarray) -> np.ndarray:
    """``encode_counts`` in numpy."""
    flat = np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F")
    if flat.size == 0:
        return np.zeros(0, np.uint32)
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).astype(np.uint32)
    if flat[0] == 1:
        runs = np.concatenate([[np.uint32(0)], runs])
    return runs


def decode_counts_plain(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """``decode_counts`` in numpy."""
    counts = np.asarray(counts, np.uint32)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    flat = np.resize(flat, h * w) if flat.size != h * w else flat
    return flat.reshape((h, w), order="F")


def _counts_to_string(counts: np.ndarray) -> bytes:
    s = bytearray()
    cnts = counts.astype(np.int64)
    for i, x in enumerate(cnts):
        if i > 2:
            x = x - cnts[i - 2]
        x = int(x)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            s.append(c + 48)
    return bytes(s)


def _string_to_counts(s: bytes) -> np.ndarray:
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.uint32)


def _counts(rle: Dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode()
    if isinstance(counts, bytes):
        return _string_to_counts(counts)
    return np.asarray(counts, np.uint32)


def encode(mask: np.ndarray) -> Dict:
    """Binary mask -> COCO RLE dict (compressed counts)."""
    h, w = mask.shape
    return {"size": [int(h), int(w)],
            "counts": _counts_to_string(encode_counts(mask))}


def decode(rle: Dict) -> np.ndarray:
    """COCO RLE dict -> binary mask uint8 (h, w)."""
    h, w = rle["size"]
    return decode_counts(_counts(rle), h, w)


def area(rle: Dict) -> int:
    return int(np.asarray(_counts(rle)[1::2], np.int64).sum())


def iou(rle_a: Dict, rle_b: Dict) -> float:
    """IoU of two RLE masks: the C++ codec intersects the runs without a
    decode; the plain version decodes both."""
    lib = _native()
    if lib is None:
        return iou_plain(rle_a, rle_b)
    ca = np.ascontiguousarray(_counts(rle_a), np.uint32)
    cb = np.ascontiguousarray(_counts(rle_b), np.uint32)
    return float(lib.rle_iou(_u32(ca), ca.size, _u32(cb), cb.size))


def iou_plain(rle_a: Dict, rle_b: Dict) -> float:
    """``iou`` in numpy, through ``decode_counts_plain``."""
    a = decode_counts_plain(_counts(rle_a), *rle_a["size"]).astype(bool)
    b = decode_counts_plain(_counts(rle_b), *rle_b["size"]).astype(bool)
    union = (a | b).sum()
    return float((a & b).sum() / union) if union else 0.0
