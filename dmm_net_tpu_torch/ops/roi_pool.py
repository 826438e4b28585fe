"""Feature pooling: mask-weighted averages (DMM-Net's per-mask feature) and
ROI-Align (the proposal detector's box pooling).

ROI-Align here is channel-first: one pyramid level (C, H, W) and boxes
(K, 4) as (x1, y1, x2, y2) in input coordinates give (K, C, oh, ow), the
layout the detector's heads consume (the JAX package's ops are channel-last,
(H, W, C) -> (K, oh, ow, C)). Both forms have aligned semantics: sample
positions carry the half-pixel offset and are clamped to the map before the
floor, so a box at the border puts full weight on the edge pixel.

  * ``roi_align``: the gather form, four corner reads per sample point;
  * ``roi_align_mxu``: the separable form, ``A_y(k) @ feat @ A_x(k)^T`` with
    per-box interpolation matrices; the plain version of kernel B4
    (kernels/roi_align.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dmm_net_tpu_torch.ops.resize import resize


def mask_avg_pool(feats: torch.Tensor, masks: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """feats (..., H, W, C) channel-last, as in the JAX package; masks
    (..., K, h, w) soft masks at any resolution (resized to (H, W)).
    Returns (..., K, C) float32; empty masks give the zero vector."""
    H, W, C = feats.shape[-3:]
    masks = resize(masks, (H, W))
    m = masks.float().reshape(masks.shape[:-2] + (H * W,))
    f = feats.float().reshape(feats.shape[:-3] + (H * W, C))
    pooled = m @ f
    denom = m.sum(-1, keepdim=True)
    return pooled / denom.clamp_min(eps)


def roi_align(feats: torch.Tensor, boxes: torch.Tensor,
              out_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 2,
              spatial_scale: float = 1.0) -> torch.Tensor:
    """Gather-form ROI-Align: feats (C, H, W), boxes (K, 4) -> (K, C, oh, ow)."""
    C, H, W = feats.shape
    oh, ow = out_size
    s = sampling_ratio
    dev = feats.device
    b = boxes.float() * spatial_scale
    x1, y1, x2, y2 = b.unbind(-1)
    cell_w = (x2 - x1).clamp_min(1e-3) / ow
    cell_h = (y2 - y1).clamp_min(1e-3) / oh
    sub = (torch.arange(s, device=dev)[None, :] + 0.5) / s
    gx = torch.arange(ow, device=dev)[:, None] + sub               # (ow, s)
    gy = torch.arange(oh, device=dev)[:, None] + sub               # (oh, s)
    sx = (x1[:, None, None] + gx[None] * cell_w[:, None, None] - 0.5).clamp(0.0, W - 1.0)
    sy = (y1[:, None, None] + gy[None] * cell_h[:, None, None] - 0.5).clamp(0.0, H - 1.0)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy = (sy - y0)[:, :, :, None, None]                            # (K, oh, s, 1, 1)
    wx = (sx - x0)[:, None, None, :, :]                            # (K, 1, 1, ow, s)
    y0i = y0.long().clamp(0, H - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    x0i = x0.long().clamp(0, W - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    flat = feats.float().reshape(C, H * W)

    def g(yi, xi):                                   # -> (C, K, oh, s, ow, s)
        return flat[:, yi[:, :, :, None, None] * W + xi[:, None, None, :, :]]

    out = (g(y0i, x0i) * (1 - wy) * (1 - wx) + g(y0i, x1i) * (1 - wy) * wx
           + g(y1i, x0i) * wy * (1 - wx) + g(y1i, x1i) * wy * wx)
    return out.mean(dim=(3, 5)).permute(1, 0, 2, 3)


def _interp_matrix(start: torch.Tensor, size: torch.Tensor, out: int, s: int,
                   dim: int) -> torch.Tensor:
    """Per-box 1-D interpolation matrices (K, out, dim): each row averages
    the bilinear weights of the s sample points of one output cell."""
    i = torch.arange(out * s, dtype=torch.float32, device=start.device)
    pos = start[:, None] + (i + 0.5) / (out * s) * size.clamp_min(1e-3)[:, None] - 0.5
    pos = pos.clamp(0.0, dim - 1.0)
    p0 = torch.floor(pos)
    d = pos - p0
    p0c = p0.long().clamp(0, dim - 1)
    p1c = (p0c + 1).clamp(0, dim - 1)
    cols = torch.arange(dim, device=start.device)
    R = ((1.0 - d)[..., None] * (p0c[..., None] == cols)
         + d[..., None] * (p1c[..., None] == cols))
    return R.reshape(start.shape[0], out, s, dim).mean(dim=2)


def roi_align_mxu(feats: torch.Tensor, boxes: torch.Tensor,
                  out_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 2,
                  spatial_scale: float = 1.0) -> torch.Tensor:
    """Separable ROI-Align: feats (C, H, W), boxes (K, 4) -> (K, C, oh, ow);
    same function as ``roi_align``, as two products per box. Float32, or
    float64 for float64 feats (the interpolation weights are float32 either
    way), so that autograd's gradcheck can hold B4''s backward."""
    C, H, W = feats.shape
    oh, ow = out_size
    dt = torch.promote_types(feats.dtype, torch.float32)
    b = boxes.float() * spatial_scale
    Ay = _interp_matrix(b[:, 1], b[:, 3] - b[:, 1], oh, sampling_ratio, H).to(dt)
    Ax = _interp_matrix(b[:, 0], b[:, 2] - b[:, 0], ow, sampling_ratio, W).to(dt)
    t = torch.einsum("kyh,chw->kcyw", Ay, feats.to(dt))
    return torch.einsum("kxw,kcyw->kcyx", Ax, t)
