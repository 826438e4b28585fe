"""The weights both sides run: drawn from the seed on the device, in one
call to the generator, laid out by the reference's module tree (whose
parameter names are the program's). The same dict loads into the program
(``load_state_dict``, which casts each tensor to the parameter's dtype) and
into the reference.

Kernels and dense layers take a normal of variance 1 / fan_in (2 / fan_in
in the decoder, where ReLUs follow); biases a small normal; the frozen
BatchNorms a scale near 1 (near 0.5 on the last of a residual branch), a
small shift and running statistics near (0, 1). Two choices keep the
labels from being ties between objects: each per-object conv's weights on
the object's own mask channel are drawn at unit scale times 3, so that an
object's mask shapes its logits, and the output conv's at 4 times its
fan-in scale, so that logits are of order 1 rather than 0.05 (measured on
the CPU at 256x448: the median gap between an object's logit and the next
is then 10-20% of the logit on the first frame, against 0.2%).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from benchmark.reference.model import FrozenBN


def _roles(model: nn.Module):
    """(name, shape, role) for every parameter and buffer, in state-dict
    order."""
    out = []
    for mod_name, mod in model.named_modules():
        prefix = mod_name + "." if mod_name else ""
        for name, t in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            if isinstance(mod, FrozenBN):
                last = name == "weight" and mod_name.endswith("bn2")
                role = "bn_" + name + ("_last" if last else "")
            elif name == "bias":
                role = "bias"
            else:
                role = "kernel"
            out.append((prefix + name, tuple(t.shape), role))
    return out


def make_state_dict(model_meta: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors on ``device`` for every entry of ``model_meta``'s
    state dict (the model may live on the meta device)."""
    roles = _roles(model_meta)
    total = sum(int(torch.Size(s).numel()) for _, s, _ in roles)
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7919 + 11) % (2 ** 63))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    with torch.no_grad():
        for name, shape, role in roles:
            n = int(torch.Size(shape).numel())
            z = flat[off:off + n].view(shape)
            off += n
            if role == "kernel":
                fan_in = n // shape[0]
                gain = 2.0 if name.startswith("decoder.") else 1.0   # ReLUs follow
                v = z * (gain / fan_in) ** 0.5
                if name.split(".")[1].startswith(("obj_head", "obj_merge")):
                    v[:, -1] = 3.0 * z[:, -1]    # the object's own mask channel
                if name == "decoder.out.weight":
                    v = v * 4.0
            elif role == "bias":
                v = z * 0.02
            elif role.startswith("bn_weight"):
                v = (0.5 if role.endswith("_last") else 1.0) + 0.1 * z
            elif role == "bn_running_var":
                v = 1.0 + 0.2 * z.abs()
            else:                              # bn bias, running mean
                v = 0.1 * z
            out[name] = v
    return out

