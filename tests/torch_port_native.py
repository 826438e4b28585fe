"""The JAX package's C++ host libraries built for a test, and the pins of
both packages' decode and RLE paths.

``build_jax_library`` compiles ``native/loader/imgloader.cpp`` or
``native/rle/maskrle.cpp`` with ``native/build.py``'s flags into a
directory of the caller's (never ``native/``, so no shared library is
written while other test processes load it), once per process, and binds
it with the signatures the JAX modules give it. The fixtures' helpers then
point ``dmm_net_tpu.data.native_loader`` / ``dmm_net_tpu.ops.rle`` at it
through their ``_LIB``. Imports no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent
_SOURCES = {"imgloader": (_REPO / "native" / "loader" / "imgloader.cpp",
                          ("-ljpeg", "-lpng", "-lpthread")),
            "maskrle": (_REPO / "native" / "rle" / "maskrle.cpp", ())}
_built = {}


def build_jax_library(name: str, directory) -> ctypes.CDLL:
    """The JAX package's ``name`` library ("imgloader" or "maskrle"), built
    with ``native/build.py``'s flags into ``directory`` (once per process)."""
    if name not in _built:
        src, libs = _SOURCES[name]
        out = Path(directory) / f"lib{name}.so"
        subprocess.run(["g++", "-std=c++17", "-shared", "-fPIC", "-O3",
                        "-march=native", str(src), "-o", str(out), *libs],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(out))
        # the same C interfaces as the port's copies
        if name == "imgloader":
            from dmm_net_tpu_torch.data.native_loader import _bind
        else:
            from dmm_net_tpu_torch.ops.rle import _bind
        _bind(lib)
        _built[name] = lib
    return _built[name]


def pin_port_to_pil(monkeypatch) -> None:
    """The port's readers decode with PIL for this test."""
    from dmm_net_tpu_torch.data import native_loader
    monkeypatch.setattr(native_loader, "_TRIED", True)
    monkeypatch.setattr(native_loader, "_LIB", None)


def pin_both_native(monkeypatch, jax_native_loader, directory) -> None:
    """Both packages' readers decode with their C++ loaders: the JAX one
    built here from its own source, the port's from its copy."""
    from dmm_net_tpu_torch.data import native_loader
    if not native_loader.available():
        raise RuntimeError(f"the port's native loader: {native_loader.reason()}")
    monkeypatch.setattr(jax_native_loader, "_TRIED", True)
    monkeypatch.setattr(jax_native_loader, "_LIB",
                        build_jax_library("imgloader", directory))
