"""zstd decoding through the system's libzstd, bound with ctypes.

The JAX package's orbax checkpoints compress every B-tree node of their
OCDBT store and every zarr chunk with zstd (utils/ocdbt.py,
utils/checkpoint.py). This module binds the four functions of libzstd's
stable API that decoding needs, with their prototypes declared here, so no
header and no build is needed:

    unsigned long long ZSTD_getFrameContentSize(const void *src, size_t n);
    size_t ZSTD_decompress(void *dst, size_t cap, const void *src, size_t n);
    unsigned ZSTD_isError(size_t code);
    const char *ZSTD_getErrorName(size_t code);

The library is loaded at the first call, never at import. There is one
route: without ``libzstd.so.1`` a call raises, naming it. Frames that do
not record their content size (tensorstore writes its zarr chunks so)
decode into a buffer that grows until the frame fits, up to ``LIMIT``
bytes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

LIBRARY = "libzstd.so.1"
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2
_MIN_CAPACITY = 1 << 16
LIMIT = 1 << 34  # the most a frame of unrecorded size may decode to


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(LIBRARY)
    except OSError as e:
        raise RuntimeError(f"zstd: cannot load {LIBRARY} ({e}); the port "
                           "decodes zstd through the system's libzstd "
                           "only") from None
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    return lib


def content_size(frame: bytes) -> Optional[int]:
    """The content size the first frame records, or None when it records
    none. Raises on bytes that do not start a zstd frame."""
    n = _lib().ZSTD_getFrameContentSize(frame, len(frame))
    if n == _CONTENTSIZE_ERROR:
        raise ValueError("zstd: not a zstd frame")
    return None if n == _CONTENTSIZE_UNKNOWN else int(n)


def decompress(frames: bytes, size: Optional[int] = None) -> bytes:
    """Decode one or more concatenated zstd frames. ``size``, where the
    caller knows it, is the decoded length, held exactly; otherwise the
    buffer starts at the first frame's recorded size (or a guess where it
    records none) and doubles until the frames fit, up to ``LIMIT`` bytes."""
    lib = _lib()
    known = size if size is not None else content_size(frames)
    cap = known if known is not None else max(4 * len(frames), _MIN_CAPACITY)
    while True:
        out = ctypes.create_string_buffer(max(cap, 1))
        n = lib.ZSTD_decompress(out, cap, frames, len(frames))
        if not lib.ZSTD_isError(n):
            break
        error = lib.ZSTD_getErrorName(n).decode()
        # a frame with no recorded size (or several frames) outgrew the
        # buffer: grow it; any other error is the data's
        if "too small" not in error or size is not None or cap >= LIMIT:
            raise ValueError(f"zstd: {error} ({len(frames)} bytes in, "
                             f"{cap} bytes of room)")
        cap = min(2 * cap, LIMIT)
    if size is not None and n != size:
        raise ValueError(f"zstd: decoded {n} bytes, expected {size}")
    return ctypes.string_at(out, n)
