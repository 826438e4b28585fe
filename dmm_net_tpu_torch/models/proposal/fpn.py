"""Feature Pyramid Network over the ResNet backbone: P2..P6 from c2..c5.

Counterpart of the JAX package's models/proposal/fpn.py, NCHW. The top-down
path upsamples by nearest neighbour at half-pixel centres (torch's
``"nearest-exact"``, the sampling ``jax.image.resize(..., "nearest")``
uses); it equals plain ``"nearest"`` only where each level halves exactly.
P6 is a 1x1 max-pool with stride 2 on P5, i.e. every other pixel.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from dmm_net_tpu_torch.models.layers import Conv


class FPN(nn.Module):
    def __init__(self, in_channels: Dict[str, int], out_channels: int = 256):
        super().__init__()
        for lvl in ("c2", "c3", "c4", "c5"):
            setattr(self, f"lateral_{lvl}", Conv(in_channels[lvl], out_channels, 1))
        for lvl in ("p2", "p3", "p4", "p5"):
            setattr(self, f"post_{lvl}", Conv(out_channels, out_channels, 3))

    def forward(self, feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        lat = {lvl: getattr(self, f"lateral_{lvl}")(feats[lvl].float())
               for lvl in ("c2", "c3", "c4", "c5")}
        p = {"p5": lat["c5"]}
        for src, dst, up in (("c4", "p4", "p5"), ("c3", "p3", "p4"),
                             ("c2", "p2", "p3")):
            p[dst] = lat[src] + F.interpolate(p[up], size=lat[src].shape[-2:],
                                              mode="nearest-exact")
        out = {lvl: getattr(self, f"post_{lvl}")(p[lvl])
               for lvl in ("p2", "p3", "p4", "p5")}
        out["p6"] = out["p5"][:, :, ::2, ::2]
        return out
