"""Numerical-safety tooling: the counterpart of the JAX package's
utils/debug.py.

  * ``enable_nan_debugging()``: a forward hook on every module raises at
    the first module whose output is not finite, and autograd's anomaly
    mode names the forward operation of a backward that produces one (the
    JAX package's ``jax_debug_nans`` / ``jax_debug_infs``). Each check
    reads the result back to the host: debugging only;
  * ``checked(fn)``: ``fn`` whose outputs are checked, raising on a value
    that is not finite (the JAX package's ``checkify`` wrapper; an index
    out of range already raises in PyTorch).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.hooks import RemovableHandle

# The hook is global, as the JAX package's debug flags are: one handle for
# the process, removed by enable_nan_debugging(False).
_hook: Optional[RemovableHandle] = None


def _first_non_finite(tree, path: str = "output") -> Optional[str]:
    """The path of the first floating tensor or array in ``tree`` (nested
    dicts, lists, tuples) holding a NaN or an infinity, or None."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if isinstance(tree, torch.Tensor):
            bad = tree.is_floating_point() and not bool(torch.isfinite(tree).all())
        elif isinstance(tree, np.ndarray):
            bad = tree.dtype.kind == "f" and not bool(np.isfinite(tree).all())
        elif isinstance(tree, float):
            bad = not np.isfinite(tree)
        else:
            bad = False
        return path if bad else None
    for k, v in items:
        hit = _first_non_finite(v, f"{path}[{k!r}]")
        if hit is not None:
            return hit
    return None


def _check_output(module, inputs, output) -> None:
    hit = _first_non_finite(output)
    if hit is not None:
        raise FloatingPointError(f"{type(module).__name__}: {hit} is not "
                                 "finite")


def enable_nan_debugging(enable: bool = True) -> None:
    """Raise at the first module (forward) or operation (backward) that
    produces a NaN or an infinity; ``False`` turns both checks off."""
    global _hook
    if _hook is not None:
        _hook.remove()
        _hook = None
    if enable:
        _hook = torch.nn.modules.module.register_module_forward_hook(
            _check_output)
    torch.autograd.set_detect_anomaly(enable)


def checked(fn: Callable) -> Callable:
    """``fn`` with its outputs checked: raises FloatingPointError when one
    is not finite."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        hit = _first_non_finite(out)
        if hit is not None:
            raise FloatingPointError(f"{getattr(fn, '__name__', fn)}: {hit} "
                                     "is not finite")
        return out

    return wrapper
