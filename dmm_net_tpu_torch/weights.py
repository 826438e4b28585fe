"""Weight bridge between JAX-package checkpoint variables and the port's
state_dict, both ways.

The JAX package saves ``{"params": ..., "batch_stats": ...}`` as nested
dicts (flax msgpack blobs carry them under "variables"). The port's module
tree mirrors the flax tree, so the bridge is a rename plus layout changes:

  * conv kernels HWIO -> OIHW; ``nn.Dense`` kernels (in, out) -> (out, in);
  * ``nn.ConvTranspose`` kernels (kh, kw, I, O) -> (I, O, kh, kw) with the
    spatial axes flipped (flax correlates, torch's transposed conv
    convolves). A transposed conv is known by its module type when a model
    is given, else by name (``_TRANSPOSED``); with I = O a shape check
    cannot tell the two layouts apart;
  * ``scale`` -> ``weight``; batch stats ``mean``/``var`` ->
    ``running_mean``/``running_var``;
  * ``BasicBlock_i``/``BottleneckBlock_i`` -> ``blocks.i``, ``Conv_k`` ->
    ``conv{k}``, ``BatchNorm_k`` -> ``bn{k}``, ``DeformConv_k`` ->
    ``deform{k}`` (a DCNv2 block numbers its deformable and its plain convs
    apart, as flax does, and the port's block names its layers the same
    way); every other name (``gate_z``, ``gate_r``, ``cand``, ``obj_head``,
    ``offset_conv``, ...) is kept. Fused-conv parameter holders map whole.

It is strict in both directions: a source leaf that does not map raises,
and against a model, a parameter or buffer left unfilled, a key left over,
or a shape that differs raises. ``to_flax_variables`` is the exact inverse
(the port's trained detector saves through it), read off the model's
module types.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from dmm_net_tpu_torch.models.layers import BatchNorm, ConvTranspose

_RENAMES = ((re.compile(r"^(?:BasicBlock|BottleneckBlock)_(\d+)$"), r"blocks.\1"),
            (re.compile(r"^Conv_(\d+)$"), r"conv\1"),
            (re.compile(r"^BatchNorm_(\d+)$"), r"bn\1"),
            (re.compile(r"^DeformConv_(\d+)$"), r"deform\1"))
_INVERSE = ((re.compile(r"^conv(\d+)$"), r"Conv_\1"),
            (re.compile(r"^bn(\d+)$"), r"BatchNorm_\1"),
            (re.compile(r"^deform(\d+)$"), r"DeformConv_\1"))
_BLOCKS = ("BasicBlock", "BottleneckBlock")
# Transposed convs of the JAX package's trees, for conversion without a model.
_TRANSPOSED = frozenset({"conv5_mask"})
_LEAVES = {"params": {"kernel": "weight", "bias": "bias", "scale": "weight"},
           "batch_stats": {"mean": "running_mean", "var": "running_var"}}


def _walk(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _walk(v, path + (str(k),))
        else:
            yield path + (str(k),), np.asarray(v)


def _module_name(part: str) -> str:
    for pat, repl in _RENAMES:
        if pat.match(part):
            return pat.sub(repl, part)
    return part


def convert_flax_variables(variables, model: Optional[torch.nn.Module] = None
                           ) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} nested numpy dicts -> float32 state_dict.
    With ``model``, also checks that the keys and shapes are exactly the
    model's parameters and buffers (its parameters alone when only
    "params" is given)."""
    extra = set(variables) - set(_LEAVES)
    if extra:
        raise KeyError(f"unknown variable collections {sorted(extra)}")
    if model is not None:
        transposed = {name for name, m in model.named_modules()
                      if isinstance(m, ConvTranspose)}
    sd: Dict[str, torch.Tensor] = {}
    for coll, leaves in _LEAVES.items():
        for path, arr in _walk(variables.get(coll, {})):
            leaf = path[-1]
            if leaf not in leaves:
                raise KeyError(f"{coll}/{'/'.join(path)}: no mapping for "
                               f"leaf {leaf!r}")
            module = ".".join(_module_name(p) for p in path[:-1])
            if leaf == "kernel":
                is_t = (module in transposed if model is not None
                        else path[-2] in _TRANSPOSED)
                if arr.ndim == 4 and is_t:
                    arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)  # -> (I, O, kh, kw)
                elif arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
                elif arr.ndim == 2:
                    arr = arr.T                              # (in, out) -> (out, in)
                else:
                    raise ValueError(f"{coll}/{'/'.join(path)}: kernel of "
                                     f"rank {arr.ndim}")
            key = f"{module}.{leaves[leaf]}" if module else leaves[leaf]
            if key in sd:
                raise KeyError(f"{coll}/{'/'.join(path)} maps onto {key!r} twice")
            sd[key] = torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32)
    if model is not None:
        # the model's entries of the collections given ("params" alone for
        # an optimizer's per-parameter state)
        params = {n for n, _ in model.named_parameters()}
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()
                if ("params" if k in params else "batch_stats") in variables}
        missing = sorted(set(want) - set(sd))
        left = sorted(set(sd) - set(want))
        if missing or left:
            raise KeyError(f"weight bridge: unfilled in the model {missing}; "
                           f"left over from the checkpoint {left}")
        bad = [(k, tuple(sd[k].shape), want[k]) for k in want
               if tuple(sd[k].shape) != want[k]]
        if bad:
            raise ValueError(f"weight bridge: shape mismatches {bad}")
    return sd


def load_flax_variables(model: torch.nn.Module, variables) -> None:
    """Load JAX-package variables into ``model`` (strict)."""
    sd = convert_flax_variables(variables, model)
    model.load_state_dict(sd, strict=True)


def _flax_path(model: torch.nn.Module, modules, path: str) -> Tuple[str, ...]:
    """The flax module names of a port module path."""
    parts = path.split(".") if path else []
    out = []
    i = 0
    while i < len(parts):
        if parts[i] == "blocks" and i + 1 < len(parts):
            kind = type(modules[".".join(parts[:i + 2])]).__name__
            if kind not in _BLOCKS:
                raise KeyError(f"{path}: blocks.{parts[i + 1]} is a {kind}, "
                               f"not one of {_BLOCKS}")
            out.append(f"{kind}_{parts[i + 1]}")
            i += 2
            continue
        name = parts[i]
        for pat, repl in _INVERSE:
            if pat.match(name):
                name = pat.sub(repl, name)
                break
        out.append(name)
        i += 1
    return tuple(out)


def to_flax_variables(model: torch.nn.Module):
    """The model's state_dict -> {"params", "batch_stats"} nested dicts of
    float32 numpy arrays in the JAX package's layout: the exact inverse of
    ``convert_flax_variables`` (OIHW -> HWIO, (out, in) -> (in, out), the
    transposed conv's flip undone, ``weight`` -> ``kernel`` or a
    BatchNorm's ``scale``, ``running_*`` -> ``mean``/``var``, the port's
    module names -> flax's). Strict: a key it cannot place raises, and the
    result is checked against the model by ``convert_flax_variables``."""
    modules = dict(model.named_modules())
    out = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        path, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        m = modules[path]
        arr = t.detach().float().cpu().numpy()
        if leaf in ("running_mean", "running_var") and isinstance(m, BatchNorm):
            coll, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight" and isinstance(m, BatchNorm):
            coll, name = "params", "scale"
        elif leaf == "weight":
            coll, name = "params", "kernel"
            if arr.ndim == 4 and isinstance(m, ConvTranspose):
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]   # -> (kh, kw, I, O)
            elif arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)                # OIHW -> HWIO
            elif arr.ndim == 2:
                arr = arr.T                                    # (out, in) -> (in, out)
            else:
                raise ValueError(f"{key}: weight of rank {arr.ndim}")
        elif leaf == "bias":
            coll, name = "params", "bias"
        else:
            raise KeyError(f"{key}: no flax name for leaf {leaf!r}")
        node = out[coll]
        for part in _flax_path(model, modules, path):
            node = node.setdefault(part, {})
        if name in node:
            raise KeyError(f"{key} maps onto {coll}/{name} twice")
        node[name] = np.ascontiguousarray(arr)
    convert_flax_variables(out, model)       # strict: keys and shapes
    return out
