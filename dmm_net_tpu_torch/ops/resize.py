"""Bilinear resize: the port's counterpart of every ``jax.image.resize(...,
method="bilinear")`` in the JAX package.

jax.image.resize antialiases when it downscales (a triangle filter widened
by the scale factor) and samples at half-pixel centers with edge
renormalisation when it upscales. ``F.interpolate(mode="bilinear",
align_corners=False, antialias=True)`` computes the same weights; without
``antialias`` a downscale differs by up to 0.4 on masks.

PyTorch's antialiased bilinear is not implemented for bfloat16 on the CPU,
so the resize runs in float32 and the result is cast back to the input's
type.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def resize(x: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    """Resize the trailing two (h, w) dims of ``x`` to ``hw``; leading dims
    are kept. No-op when the size already matches."""
    hw = (int(hw[0]), int(hw[1]))
    if tuple(x.shape[-2:]) == hw:
        return x
    lead = x.shape[:-2]
    x4 = x.reshape((1, -1) + tuple(x.shape[-2:])).float()
    y = F.interpolate(x4, size=hw, mode="bilinear", align_corners=False,
                      antialias=True)
    return y.reshape(lead + hw).to(x.dtype)
