"""Mask losses, the counterpart of the JAX package's train/losses.py.

Pixel-wise sigmoid BCE plus a soft-IoU auxiliary on per-object mask
logits. Everything is mask-aware: padded objects and padded frames add
exactly zero loss and zero gradient.
"""

from __future__ import annotations

import torch


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jnp.logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mask_bce_loss(logits: torch.Tensor, targets: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Pixel-wise sigmoid BCE averaged over valid objects' pixels, as
    optax's ``sigmoid_binary_cross_entropy``: -t log s(x) - (1-t) log s(-x).

    logits, targets: (..., M, H, W); valid: (..., M) bool."""
    t = targets.float()
    per_px = t * _softplus(-logits) + (1.0 - t) * _softplus(logits)
    per_obj = per_px.mean(dim=(-2, -1))
    v = valid.float()
    return (per_obj * v).sum() / v.sum().clamp_min(1.0)


def soft_iou_loss(logits: torch.Tensor, targets: torch.Tensor,
                  valid: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """1 - soft Jaccard, averaged over valid objects whose ground truth is
    not empty (an empty GT has inter == 0 and a zero gradient: a constant
    that would only mis-scale the loss; BCE supervises those pixels)."""
    # sigmoid, clipped as jnp.clip is: min(max(p, 0), 1), whose gradient is
    # halved where p sits exactly on a bound (p == 1 for logits above ~17)
    p = torch.exp(-_softplus(-logits))
    p = torch.minimum(torch.maximum(p, torch.zeros_like(p)), torch.ones_like(p))
    t = targets.float()
    inter = (p * t).sum(dim=(-2, -1))
    union = (p + t - p * t).sum(dim=(-2, -1))
    iou = inter / union.clamp_min(eps)
    nonempty = (t.sum(dim=(-2, -1)) > 0).float()
    v = valid.float() * nonempty
    return ((1.0 - iou) * v).sum() / v.sum().clamp_min(1.0)


def clip_loss(logits: torch.Tensor, targets: torch.Tensor,
              valid: torch.Tensor, bce_weight: float = 1.0,
              iou_weight: float = 0.5) -> torch.Tensor:
    """Combined loss over (B, T, M, H, W) logits and targets; ``valid`` is
    (B, M), broadcast over T, or (B, T, M). Frames before an object appears
    are still supervised against its (empty) GT unless ``valid`` is 3-D."""
    v = valid[:, None, :] if valid.dim() == 2 else valid
    v = v.expand(logits.shape[:3])
    total = bce_weight * mask_bce_loss(logits, targets, v)
    if iou_weight:
        total = total + iou_weight * soft_iou_loss(logits, targets, v)
    return total
