"""Mask-weighted average pooling of a feature map (DMM-Net's per-mask
feature). ROI-Align is not ported yet."""

from __future__ import annotations

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
