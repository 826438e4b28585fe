"""ResNet backbone returning the {c1..c5} pyramid (strides 2..32), NCHW.

Counterpart of the JAX package's models/resnet.py. BatchNorm is frozen
(eps 1e-5) unless the backbone is built with ``train_bn``, which gives its
BatchNorms batch statistics in training mode (models/layers.BatchNorm).
The stem is a plain 7x7/s2 conv with pad 3: the JAX
package's space-to-depth stem is an exact rewrite of that conv. Stride-2
3x3 convs pad (1, 1) on both sides, then max-pool 3/2 pad 1.

``deform_stages`` (e.g. ("c3", "c4", "c5"), the reference's deformable
R-50 configurations) swaps the spatial 3x3 conv of every block in those
stages for DCNv2 (ops/deform_conv.DeformConv): a bottleneck's middle conv,
both convs of a basic block.

Module names follow the flax tree so the weight bridge (weights.py) is a
rename: ``BasicBlock_i`` / ``BottleneckBlock_i`` -> ``blocks.i``,
``Conv_k`` -> ``conv{k}``, ``BatchNorm_k`` -> ``bn{k}``, ``DeformConv_k``
-> ``deform{k}``. flax numbers a block's plain and deformable convs apart,
so a deformable bottleneck holds ``conv0``, ``deform0`` and ``conv1``.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dmm_net_tpu_torch.models.layers import BatchNorm, Conv
from dmm_net_tpu_torch.ops.deform_conv import DeformConv


def _conv3x3(cin: int, cout: int, stride: int, dtype, deform: bool):
    if deform:
        return DeformConv(cin, cout, 3, stride, dtype=dtype)
    return Conv(cin, cout, 3, stride, 1, bias=False, dtype=dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) with residual."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype,
                 norm=BatchNorm, deform: bool = False):
        super().__init__()
        out = filters * 4
        self.conv0 = Conv(cin, filters, 1, bias=False, dtype=dtype)
        self.bn0 = norm(filters, dtype)
        # flax's names: Conv_1 is the 3x3, or the 1x1 after a DeformConv_0
        self._mid, self._last = ("deform0", "conv1") if deform else ("conv1", "conv2")
        setattr(self, self._mid, _conv3x3(filters, filters, stride, dtype, deform))
        self.bn1 = norm(filters, dtype)
        setattr(self, self._last, Conv(filters, out, 1, bias=False, dtype=dtype))
        self.bn2 = norm(out, dtype, zero_scale=True)
        self.has_proj = stride != 1 or cin != out
        if self.has_proj:
            self.conv_proj = Conv(cin, out, 1, stride, 0, bias=False, dtype=dtype)
            self.norm_proj = norm(out, dtype)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(getattr(self, self._mid)(y)))
        y = self.bn2(getattr(self, self._last)(y))
        res = self.norm_proj(self.conv_proj(x)) if self.has_proj else x
        return F.relu(y + res)


class BasicBlock(nn.Module):
    """3x3 (stride) -> 3x3 with residual (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype,
                 norm=BatchNorm, deform: bool = False):
        super().__init__()
        self._convs = ("deform0", "deform1") if deform else ("conv0", "conv1")
        setattr(self, self._convs[0], _conv3x3(cin, filters, stride, dtype, deform))
        self.bn0 = norm(filters, dtype)
        setattr(self, self._convs[1], _conv3x3(filters, filters, 1, dtype, deform))
        self.bn1 = norm(filters, dtype, zero_scale=True)
        self.has_proj = stride != 1 or cin != filters
        if self.has_proj:
            self.conv_proj = Conv(cin, filters, 1, stride, 0, bias=False, dtype=dtype)
            self.norm_proj = norm(filters, dtype)

    def forward(self, x):
        y = F.relu(self.bn0(getattr(self, self._convs[0])(x)))
        y = self.bn1(getattr(self, self._convs[1])(y))
        res = self.norm_proj(self.conv_proj(x)) if self.has_proj else x
        return F.relu(y + res)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block_cls, dtype,
                 num_filters: int = 64, train_bn: bool = False,
                 deform_stages: Sequence[str] = ()):
        super().__init__()
        self.dtype = dtype
        norm = partial(BatchNorm, train_stats=train_bn)
        self.conv_init = Conv(3, num_filters, 7, 2, 3, bias=False, dtype=dtype)
        self.bn_init = norm(num_filters, dtype)
        blocks, self.stage_ends = [], []
        cin = num_filters
        unknown = set(deform_stages) - {f"c{i + 2}" for i in range(len(stage_sizes))}
        if unknown:
            raise ValueError(f"deform_stages: no stage {sorted(unknown)}")
        for i, count in enumerate(stage_sizes):
            filters = num_filters * 2 ** i
            deform = f"c{i + 2}" in deform_stages
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, filters, stride, dtype, norm, deform))
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


def backbone_by_name(name: str, dtype=torch.bfloat16, train_bn: bool = False,
                     deform_stages: Sequence[str] = ()) -> ResNet:
    if name not in _ARCHS:
        raise KeyError(f"unknown backbone {name!r}; have {sorted(_ARCHS)}")
    stages, block = _ARCHS[name]
    return ResNet(stages, block, dtype, train_bn=train_bn,
                  deform_stages=deform_stages)


def feature_dims(name: str) -> dict:
    """Channel count of each pyramid level for a given backbone."""
    expansion = 1 if name in ("resnet18", "resnet34") else 4
    return {"c1": 64, "c2": 64 * expansion, "c3": 128 * expansion,
            "c4": 256 * expansion, "c5": 512 * expansion}
