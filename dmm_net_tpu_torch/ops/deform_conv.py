"""Modulated deformable convolution (DCNv2): the counterpart of the JAX
package's ops/deform_conv.py, in plain PyTorch, NCHW.

The reference's detector lineage wrote DCN as CUDA im2col kernels with
atomics; the JAX package (and so this port) keeps its own design instead,
which has no Pallas kernel to port:

  * the bilinear sampling at learned offsets is a flat gather over the
    H*W axis, four corner taps per sample, with no atomics and no im2col
    scratch;
  * a tap outside the image gets weight 0 (its corner is clamped for the
    gather), so its gradient vanishes too;
  * the contraction over taps x input channels is one matrix product.

DCNv2: y(p) = sum_k w_k * m_k(p) * x(p + p_k + dp_k(p)), with offsets dp
and modulation m predicted by a regular conv. With dp = 0 and m = 1 it is
exactly a convolution with symmetric padding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from dmm_net_tpu_torch.models.layers import Conv


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  modulation: Optional[torch.Tensor] = None, *,
                  stride: Tuple[int, int] = (1, 1),
                  dilation: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """x (B, Ci, H, W); offsets (B, K, 2, Ho, Wo) per-tap (dy, dx) in input
    pixels, K = kh * kw in row-major tap order, (Ho, Wo) = ceil(H / s),
    ceil(W / s); weight (Co, Ci, kh, kw); modulation optional (B, K, Ho,
    Wo). Returns (B, Co, Ho, Wo). The kernel is centred on input pixel
    (i * sh, j * sw) of output cell (i, j)."""
    B, Ci, H, W = x.shape
    Co, wci, kh, kw = weight.shape
    if wci != Ci:
        raise ValueError(f"weight Ci {wci} != input Ci {Ci}")
    K = kh * kw
    sh, sw = stride
    dh, dw = dilation
    Ho, Wo = -(-H // sh), -(-W // sw)
    if tuple(offsets.shape) != (B, K, 2, Ho, Wo):
        raise ValueError(f"offsets shape {tuple(offsets.shape)} != "
                         f"{(B, K, 2, Ho, Wo)}")
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    oy = torch.arange(Ho, **f32) * sh
    ox = torch.arange(Wo, **f32) * sw
    ky = (torch.arange(kh, **f32) - (kh - 1) / 2.0) * dh
    kx = (torch.arange(kw, **f32) - (kw - 1) / 2.0) * dw
    tap_y = ky.repeat_interleave(kw)                         # (K,)
    tap_x = kx.repeat(kh)
    # absolute sample positions (B, K, Ho, Wo)
    py = oy[None, None, :, None] + tap_y[None, :, None, None] + offsets[:, :, 0].float()
    px = ox[None, None, None, :] + tap_x[None, :, None, None] + offsets[:, :, 1].float()
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0

    flat = x.reshape(B, Ci, H * W)
    n = K * Ho * Wo
    acc = None
    for cy, cx, wgt in ((y0, x0, (1 - fy) * (1 - fx)), (y0, x0 + 1, (1 - fy) * fx),
                        (y0 + 1, x0, fy * (1 - fx)), (y0 + 1, x0 + 1, fy * fx)):
        inb = (cy >= 0) & (cy <= H - 1) & (cx >= 0) & (cx <= W - 1)
        idx = (cy.clamp(0, H - 1).long() * W + cx.clamp(0, W - 1).long())
        g = flat.gather(2, idx.reshape(B, 1, n).expand(B, Ci, n))  # (B, Ci, K*Ho*Wo)
        w4 = (wgt * inb).to(x.dtype).reshape(B, 1, n)
        acc = g * w4 if acc is None else acc + g * w4
    if modulation is not None:
        acc = acc * modulation.to(acc.dtype).reshape(B, 1, n)
    # one product over taps x input channels: (Co, Ci*K) @ (B, Ci*K, Ho*Wo)
    out = weight.to(acc.dtype).reshape(Co, Ci * K) @ acc.reshape(B, Ci * K, Ho * Wo)
    return out.reshape(B, Co, Ho, Wo)


class DeformConv(nn.Module):
    """DCNv2 layer: a zero-initialised conv (``offset_conv``, float32,
    explicit symmetric padding so its grid is centred where
    ``deform_conv2d`` samples) predicts each tap's offsets and modulation
    (2 * sigmoid, so 1 at init), then ``deform_conv2d`` samples and
    contracts. At init it is exactly a plain convolution. ``weight`` is
    OIHW (flax's ``kernel`` is HWIO; the weight bridge transposes it)."""

    init_scale = 2.0    # models.layers.init_random draws weight as he_normal

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 dilation: int = 1, modulated: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if k % 2 != 1:
            raise ValueError(f"DeformConv: odd kernel sizes only, got {k}")
        self.k, self.stride, self.dilation = k, stride, dilation
        self.modulated = modulated
        self.dtype = dtype
        K = k * k
        self.offset_conv = Conv(cin, (3 if modulated else 2) * K, k, stride,
                                (k - 1) // 2)
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, dtype=dtype))
        with torch.no_grad():
            self.offset_conv.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        K = self.k * self.k
        pred = self.offset_conv(x.float())                 # (B, 2K or 3K, Ho, Wo)
        Ho, Wo = pred.shape[-2:]
        offsets = pred[:, :2 * K].reshape(B, K, 2, Ho, Wo)
        modulation = (2.0 * torch.sigmoid(pred[:, 2 * K:])
                      if self.modulated else None)
        return deform_conv2d(x.to(self.dtype), offsets, self.weight.to(self.dtype),
                             modulation, stride=(self.stride, self.stride),
                             dilation=(self.dilation, self.dilation))
