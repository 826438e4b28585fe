"""Layers with the JAX package's numerics (flax ``nn.Conv``, ``nn.BatchNorm``
and ``nn.Dense`` as that package configures them), in NCHW.

A flax conv with ``dtype=bf16`` casts its input and kernel to bf16, rounds
the product to bf16 and adds the bias in bf16. Every layer here casts its
parameters to its compute dtype inside ``forward``. An inference model
stores them in the compute dtype (the cast is then a no-op, and the same
numbers as casting float32 parameters at every call); a training model
keeps float32 master parameters, as flax's ``param_dtype=float32`` does, so
the gradient flows through the cast and the optimizer updates float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dmm_net_tpu_torch.parallel.mesh import all_reduce_sum


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
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None,
                     self.stride, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
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
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  bias, self.stride)


class BatchNorm(nn.Module):
    """BatchNorm with flax's numerics (eps 1e-5, float32 statistics, output
    cast to ``dtype``).

    Frozen (the default, and always in eval mode): normalises with the
    running statistics. With ``train_stats`` and in training mode: normalises
    with the batch's statistics over (N, H, W), mean and biased variance
    E[x^2] - E[x]^2 clipped at 0 as flax computes them, with gradients
    through both. The running statistics are not touched in ``forward``:
    the batch's are kept in ``batch_stats`` until the caller applies them
    with ``update_running_stats`` (flax's momentum 0.9 update, biased
    variance). So a forward pass that is recomputed for the backward
    (``torch.utils.checkpoint``) cannot update them twice.

    With ``mesh`` set (a parallel.mesh.Mesh; ``train/loop.create_train_state``
    sets it), the batch statistics are those of the global batch, as
    flax's are under the JAX package's mesh: the sums of x and x^2 and the
    count are all-reduced, differentiably, and the running statistics move
    by the global values. A recomputed forward repeats its all-reduce, in
    the same order on every rank."""

    def __init__(self, ch: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5, zero_scale: bool = False,
                 train_stats: bool = False):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.train_stats = train_stats
        init_scale = torch.zeros(ch) if zero_scale else torch.ones(ch)
        self.weight = nn.Parameter(init_scale)
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.batch_stats = None
        self.mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.train_stats and self.training:
            if self.mesh is None:
                mean = x.mean(dim=(0, 2, 3))
                ex2 = (x * x).mean(dim=(0, 2, 3))
            else:
                C = x.shape[1]
                count = x.new_full((1,), x.numel() // C)
                sums = all_reduce_sum(torch.cat([x.sum(dim=(0, 2, 3)),
                                                 (x * x).sum(dim=(0, 2, 3)),
                                                 count]), self.mesh)
                mean, ex2 = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
            var = (ex2 - mean * mean).clamp_min(0.0)
            self.batch_stats = (mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)

    @torch.no_grad()
    def update_running_stats(self, momentum: float = 0.9) -> None:
        """running = momentum * running + (1 - momentum) * batch, from the
        last training-mode forward; then forget that batch."""
        if self.batch_stats is None:
            return
        mean, var = self.batch_stats
        self.running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
        self.running_var.mul_(momentum).add_((1.0 - momentum) * var)
        self.batch_stats = None


def init_random(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the reference's distributions: each conv and dense
    kernel ~ flax's ``variance_scaling(scale, "fan_in", "truncated_normal")``,
    a normal cut at 2 sigma and rescaled to variance scale / fan_in: scale 1
    (``lecun_normal``, flax's default) or a module's ``init_scale`` (2 for
    a DCNv2 main kernel, ``he_normal``). ``fan_in`` is flax's: input channels x kernel area
    (``ConvTranspose`` keeps its inputs on axis 0). Biases 0; BatchNorm
    scales keep their constructor init (1, or 0 for the last BN of a
    residual block), and so do the DCNv2 offset predictors (``offset_conv``,
    0: each deformable conv starts as a plain one)."""
    with torch.no_grad():
        for mod_name, mod in module.named_modules():
            if "offset_conv" in mod_name.split("."):
                continue
            for name, p in mod.named_parameters(recurse=False):
                if name == "bias":
                    p.zero_()
                elif p.dim() >= 2:
                    fan_in = p[0].numel()
                    if isinstance(mod, ConvTranspose):
                        fan_in = p.shape[0] * p[0, 0].numel()
                    scale = getattr(mod, "init_scale", 1.0)
                    s = math.sqrt(scale / fan_in) / _TRUNC_STD
                    p.copy_(_unit_normal_cut_at_2(p.shape, generator) * s)


# Std of a unit normal cut at +-2 (flax's variance_scaling divides by it).
_TRUNC_STD = 0.87962566103423978


def _unit_normal_cut_at_2(shape, generator: torch.Generator) -> torch.Tensor:
    """Float32 normal values cut at +-2 by rejection: every value outside is
    drawn again from ``torch.randn`` until none is. Built on ``randn`` alone
    because ``nn.init.trunc_normal_`` draws other numbers from the same
    generator in other torch releases (inverse CDF in some, rejection in
    others), and seeded weights must not depend on the release."""
    x = torch.randn(shape, generator=generator)
    out = x.abs() > 2.0
    while out.any():
        x[out] = torch.randn(int(out.sum()), generator=generator)
        out = x.abs() > 2.0
    return x
