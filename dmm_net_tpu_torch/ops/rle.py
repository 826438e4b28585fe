"""COCO-style RLE mask codec (numpy only), for the proposal cache on disk.

The JAX package's ops/rle.py without its optional native path: dicts
{"size": [h, w], "counts": <compressed bytes>} with COCO's LEB128-style
char compression, so caches written by either package (or by cocoapi) are
read the same. Column-major ("F") order throughout, as COCO.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def encode_counts(mask: np.ndarray) -> np.ndarray:
    """Binary mask (h, w) -> uint32 run lengths (column-major, starting with
    the zero run, possibly of length 0)."""
    flat = np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F")
    if flat.size == 0:
        return np.zeros(0, np.uint32)
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).astype(np.uint32)
    if flat[0] == 1:
        runs = np.concatenate([[np.uint32(0)], runs])
    return runs


def decode_counts(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint32 run lengths -> binary mask (h, w) uint8."""
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
    a = decode(rle_a).astype(bool)
    b = decode(rle_b).astype(bool)
    union = (a | b).sum()
    return float((a & b).sum() / union) if union else 0.0
