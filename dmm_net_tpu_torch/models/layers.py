"""Layers with the JAX package's numerics (flax ``nn.Conv``, ``nn.BatchNorm``
and ``nn.Dense`` as that package configures them), in NCHW.

A flax conv with ``dtype=bf16`` casts its input and kernel to bf16, rounds
the product to bf16 and adds the bias in bf16. Parameters are stored here in
the compute dtype, which is the same numbers as casting float32 parameters
at every call (inference only).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv(nn.Module):
    """Stride-s conv with "SAME"-style symmetric padding (k // 2 unless
    given). ``weight`` is OIHW."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[int] = None, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(cout, dtype=dtype)) if bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype), self.weight, None, self.stride,
                     self.padding)
        if self.bias is not None:
            y = y + self.bias[:, None, None]
        return y


class ConvTranspose(nn.Module):
    """Transposed conv with kernel ``k`` and stride ``k`` (each input pixel
    becomes one k x k output block), as flax ``nn.ConvTranspose((k, k),
    strides=(k, k))`` computes it. ``weight`` is torch's (I, O, kh, kw); the
    weight bridge flips a flax kernel spatially on the way in, since flax
    correlates where torch convolves."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = k
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(cout, dtype=dtype)) if bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x.to(self.dtype), self.weight, self.bias,
                                  self.stride)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm (running statistics, eps 1e-5) computed in
    float32 and cast to ``dtype``, as flax does."""

    def __init__(self, ch: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5, zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        init_scale = torch.zeros(ch) if zero_scale else torch.ones(ch)
        self.weight = nn.Parameter(init_scale)
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


def init_random(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: conv and dense kernels ~ N(0, 1/fan_in) (lecun normal),
    biases 0; BatchNorm scales keep their constructor init (1, or 0 for the
    last BN of a residual block)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() >= 2:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator)
                        / math.sqrt(fan_in))
