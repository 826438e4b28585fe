"""ResNet backbone returning the {c1..c5} pyramid (strides 2..32), NCHW.

Counterpart of the JAX package's models/resnet.py, inference only (frozen
BatchNorm, eps 1e-5). The stem is a plain 7x7/s2 conv with pad 3: the JAX
package's space-to-depth stem is an exact rewrite of that conv. Stride-2
3x3 convs pad (1, 1) on both sides, then max-pool 3/2 pad 1.

Module names follow the flax tree so the weight bridge (weights.py) is a
rename: ``BasicBlock_i`` / ``BottleneckBlock_i`` -> ``blocks.i``,
``Conv_k`` -> ``conv{k}``, ``BatchNorm_k`` -> ``bn{k}``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dmm_net_tpu_torch.models.layers import Conv, FrozenBatchNorm


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) with residual."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype):
        super().__init__()
        out = filters * 4
        self.conv0 = Conv(cin, filters, 1, bias=False, dtype=dtype)
        self.bn0 = FrozenBatchNorm(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, stride, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(filters, dtype)
        self.conv2 = Conv(filters, out, 1, bias=False, dtype=dtype)
        self.bn2 = FrozenBatchNorm(out, dtype, zero_scale=True)
        self.has_proj = stride != 1 or cin != out
        if self.has_proj:
            self.conv_proj = Conv(cin, out, 1, stride, 0, bias=False, dtype=dtype)
            self.norm_proj = FrozenBatchNorm(out, dtype)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        res = self.norm_proj(self.conv_proj(x)) if self.has_proj else x
        return F.relu(y + res)


class BasicBlock(nn.Module):
    """3x3 (stride) -> 3x3 with residual (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype):
        super().__init__()
        self.conv0 = Conv(cin, filters, 3, stride, 1, bias=False, dtype=dtype)
        self.bn0 = FrozenBatchNorm(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, 1, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(filters, dtype, zero_scale=True)
        self.has_proj = stride != 1 or cin != filters
        if self.has_proj:
            self.conv_proj = Conv(cin, filters, 1, stride, 0, bias=False, dtype=dtype)
            self.norm_proj = FrozenBatchNorm(filters, dtype)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        res = self.norm_proj(self.conv_proj(x)) if self.has_proj else x
        return F.relu(y + res)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block_cls, dtype,
                 num_filters: int = 64):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2, 3, bias=False, dtype=dtype)
        self.bn_init = FrozenBatchNorm(num_filters, dtype)
        blocks, self.stage_ends = [], []
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            filters = num_filters * 2 ** i
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, filters, stride, dtype))
                cin = filters * block_cls.expansion
            self.stage_ends.append(len(blocks))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (B, 3, H, W) float -> {"c1": /2, ..., "c5": /32} in ``dtype``."""
        x = F.relu(self.bn_init(self.conv_init(x.to(self.dtype))))
        feats = {"c1": x}
        x = F.max_pool2d(x, 3, 2, 1)
        start = 0
        for i, end in enumerate(self.stage_ends):
            for blk in self.blocks[start:end]:
                x = blk(x)
            feats[f"c{i + 2}"] = x
            start = end
        return feats


_ARCHS = {"resnet18": ((2, 2, 2, 2), BasicBlock),
          "resnet34": ((3, 4, 6, 3), BasicBlock),
          "resnet50": ((3, 4, 6, 3), BottleneckBlock),
          "resnet101": ((3, 4, 23, 3), BottleneckBlock)}


def backbone_by_name(name: str, dtype=torch.bfloat16) -> ResNet:
    if name not in _ARCHS:
        raise KeyError(f"unknown backbone {name!r}; have {sorted(_ARCHS)}")
    stages, block = _ARCHS[name]
    return ResNet(stages, block, dtype)


def feature_dims(name: str) -> dict:
    """Channel count of each pyramid level for a given backbone."""
    expansion = 1 if name in ("resnet18", "resnet34") else 4
    return {"c1": 64, "c2": 64 * expansion, "c3": 128 * expansion,
            "c4": 256 * expansion, "c5": 512 * expansion}
