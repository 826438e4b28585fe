"""Mask losses, the counterpart of the JAX package's train/losses.py.

Pixel-wise sigmoid BCE plus a soft-IoU auxiliary on per-object mask
logits. Everything is mask-aware: padded objects and padded frames add
exactly zero loss and zero gradient.

On a data-parallel mesh (parallel/mesh.py) each loss is this rank's share
of the loss of the global batch, as the JAX package computes it over the
whole batch: the rank's own numerator over the global count of valid
objects (all-reduced; it carries no gradient). The shares sum to the global
loss, so the ranks' gradients are summed, not averaged. A per-rank masked
mean averaged over the ranks would differ whenever the ranks' counts do.
"""

from __future__ import annotations

from typing import Optional

import torch

from dmm_net_tpu_torch.parallel.mesh import Mesh, all_reduce_sum_


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jnp.logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _count(v: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The number of valid entries, over the whole batch on a mesh; at
    least 1."""
    n = v.sum()
    if mesh is not None:
        all_reduce_sum_([n], mesh)
    return n.clamp_min(1.0)


def mask_bce_loss(logits: torch.Tensor, targets: torch.Tensor,
                  valid: torch.Tensor, mesh: Optional[Mesh] = None
                  ) -> torch.Tensor:
    """Pixel-wise sigmoid BCE averaged over valid objects' pixels, as
    optax's ``sigmoid_binary_cross_entropy``: -t log s(x) - (1-t) log s(-x).

    logits, targets: (..., M, H, W); valid: (..., M) bool."""
    t = targets.float()
    per_px = t * _softplus(-logits) + (1.0 - t) * _softplus(logits)
    per_obj = per_px.mean(dim=(-2, -1))
    v = valid.float()
    return (per_obj * v).sum() / _count(v, mesh)


def soft_iou_loss(logits: torch.Tensor, targets: torch.Tensor,
                  valid: torch.Tensor, eps: float = 1e-6,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
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
    return ((1.0 - iou) * v).sum() / _count(v, mesh)


def clip_loss(logits: torch.Tensor, targets: torch.Tensor,
              valid: torch.Tensor, bce_weight: float = 1.0,
              iou_weight: float = 0.5, mesh: Optional[Mesh] = None
              ) -> torch.Tensor:
    """Combined loss over (B, T, M, H, W) logits and targets; ``valid`` is
    (B, M), broadcast over T, or (B, T, M). Frames before an object appears
    are still supervised against its (empty) GT unless ``valid`` is 3-D.
    With ``mesh``: this rank's share of the global batch's loss."""
    v = valid[:, None, :] if valid.dim() == 2 else valid
    v = v.expand(logits.shape[:3])
    total = bce_weight * mask_bce_loss(logits, targets, v, mesh=mesh)
    if iou_weight:
        total = total + iou_weight * soft_iou_loss(logits, targets, v,
                                                   mesh=mesh)
    return total
