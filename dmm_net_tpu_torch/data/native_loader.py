"""Native (C++) image decode for the port's readers, with PIL as fallback
and oracle.

``csrc/host/imgloader.cpp`` decodes JPEG/PNG with libjpeg/libpng and
resizes in a C++ thread pool, called through ctypes (which releases the
GIL for the call). It is built with g++ at first use
(``kernels/_build.host_library``), into ``dmm_net_tpu_torch/_build/``.

Semantics, as the JAX package's data/native_loader.py (the same C source
and flags, so both packages decode a tree to the same bytes):
  * frames -> uint8 RGB, resized with half-pixel antialiased triangle
    weights; within +-1 of PIL BILINEAR (each library rounds its own way);
  * labels -> uint8 palette INDEX maps, half-pixel NEAREST (labels are
    never interpolated).

Where the library cannot be built or loaded (no g++, no libjpeg/libpng
headers), every function decodes with PIL instead, and ``reason()`` says
why. ``announce()`` prints, once per decoder, which one the readers use.
Tests pin the PIL path by setting ``_TRIED = True`` and ``_LIB = None``.
"""

from __future__ import annotations

import ctypes
import sys
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_REASON: Optional[str] = None
_ANNOUNCED: Optional[str] = None
_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.imgl_probe.restype = ctypes.c_int
    lib.imgl_probe.argtypes = [ctypes.c_char_p, ip, ip, ip]
    for fn in (lib.imgl_decode_rgb, lib.imgl_decode_palette):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, u8p, ctypes.c_long, ip, ip]
    for fn in (lib.imgl_load_rgb_batch, lib.imgl_load_palette_batch):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int]
    return lib


def _native() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _REASON
    if _TRIED:
        return _LIB
    with _lock:
        if not _TRIED:
            from dmm_net_tpu_torch.kernels import _build
            try:
                _LIB = _bind(_build.host_library("imgloader"))
            except (RuntimeError, OSError, AttributeError) as e:
                _REASON = str(e)
            _TRIED = True
    return _LIB


def available() -> bool:
    """True when the C++ loader is built and loaded."""
    return _native() is not None


def reason() -> Optional[str]:
    """Why the readers decode with PIL (None when the library is in use)."""
    if _native() is not None:
        return None
    return _REASON or "the native loader is not loaded (pinned to PIL)"


def decoder() -> str:
    """"native" or "pil": what the readers decode with."""
    return "native" if _native() is not None else "pil"


def announce() -> str:
    """Print to stderr which decoder the readers use, once per decoder;
    returns it."""
    global _ANNOUNCED
    d = decoder()
    if d != _ANNOUNCED:
        _ANNOUNCED = d
        msg = ("native (csrc/host/imgloader.cpp)" if d == "native"
               else f"PIL ({reason()})")
        print(f"dmm_net_tpu_torch: image decode: {msg}", file=sys.stderr,
              flush=True)
    return d


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def _u8(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def probe(path: str) -> Tuple[int, int, int]:
    """(h, w, channels) from the file's header, without a decode."""
    lib = _native()
    if lib is not None:
        h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if lib.imgl_probe(path.encode(), ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(c)) == 0:
            return h.value, w.value, c.value
    from PIL import Image
    with Image.open(path) as im:
        return im.height, im.width, 1 if im.mode in ("P", "L") else 3


def load_rgb_batch(paths: Sequence[str], hw: Tuple[int, int],
                   threads: int = 8) -> np.ndarray:
    """Decode and resize frames -> (N, H, W, 3) uint8."""
    H, W = hw
    if not paths:
        return np.zeros((0, H, W, 3), np.uint8)
    lib = _native()
    if lib is not None:
        out = np.empty((len(paths), H, W, 3), np.uint8)
        if lib.imgl_load_rgb_batch(_paths_array(paths), len(paths), H, W,
                                   _u8(out), threads) == 0:
            return out
        # a file failed: PIL below raises a readable error for it
    from PIL import Image
    out = np.empty((len(paths), H, W, 3), np.uint8)
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            out[i] = np.asarray(im.convert("RGB").resize((W, H), Image.BILINEAR))
    return out


def load_label_batch(paths: Sequence[str], hw: Tuple[int, int],
                     threads: int = 8) -> np.ndarray:
    """Decode palette/gray annotations and NEAREST-resize -> (N, H, W) uint8."""
    H, W = hw
    if not paths:
        return np.zeros((0, H, W), np.uint8)
    lib = _native()
    if lib is not None:
        out = np.empty((len(paths), H, W), np.uint8)
        if lib.imgl_load_palette_batch(_paths_array(paths), len(paths), H, W,
                                       _u8(out), threads) == 0:
            return out
    from PIL import Image
    out = np.empty((len(paths), H, W), np.uint8)
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            a = np.asarray(im.resize((W, H), Image.NEAREST))
            out[i] = a[..., 0] if a.ndim == 3 else a   # RGB-coded labels
    return out


def load_rgb_native_size(path: str) -> np.ndarray:
    """One frame at its own resolution -> (h, w, 3) uint8."""
    lib = _native()
    if lib is not None:
        h, w, _ = probe(path)
        out = np.empty((h, w, 3), np.uint8)
        oh, ow = ctypes.c_int(), ctypes.c_int()
        if lib.imgl_decode_rgb(path.encode(), _u8(out), out.nbytes,
                               ctypes.byref(oh), ctypes.byref(ow)) >= 0:
            return out
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_label_native_size(path: str) -> np.ndarray:
    """One annotation at its own resolution -> (h, w) uint8 index map (an
    RGB-coded PNG read by PIL stays (h, w, 3), as in the JAX package)."""
    lib = _native()
    if lib is not None:
        h, w, _ = probe(path)
        out = np.empty((h, w), np.uint8)
        oh, ow = ctypes.c_int(), ctypes.c_int()
        if lib.imgl_decode_palette(path.encode(), _u8(out), out.nbytes,
                                   ctypes.byref(oh), ctypes.byref(ow)) >= 0:
            return out
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im)
