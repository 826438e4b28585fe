"""Pairwise template-proposal cost matrix.

c_ij = lam * (1 - IoU(mask_i, mask_j)) + (1 - lam) * (1 - cos(f_i, f_j))

Masks are dense, downsampled soft masks in [0, 1] laid out as (M, P) /
(N, P) pixel matrices, so the intersection is one matrix product and the
cosine term another. Everything is float32; the package turns TF32 off, so
the products run in full float32 as the reference pins them.
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-6


def mask_iou(tmpl_masks: torch.Tensor, prop_masks: torch.Tensor) -> torch.Tensor:
    """Pairwise soft IoU: (..., M, P), (..., N, P) -> (..., M, N)."""
    t = tmpl_masks.float()
    p = prop_masks.float()
    inter = t @ p.transpose(-1, -2)
    area_t = t.sum(-1)[..., :, None]
    area_p = p.sum(-1)[..., None, :]
    union = area_t + area_p - inter
    return inter / union.clamp_min(_EPS)


def cosine_similarity(tmpl_feats: torch.Tensor,
                      prop_feats: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine: (..., M, D), (..., N, D) -> (..., M, N). The norm is
    sqrt(sum + eps^2), so all-zero (padded) rows stay finite."""
    t = tmpl_feats.float()
    p = prop_feats.float()
    t = t * torch.rsqrt((t * t).sum(-1, keepdim=True) + _EPS * _EPS)
    p = p * torch.rsqrt((p * p).sum(-1, keepdim=True) + _EPS * _EPS)
    return t @ p.transpose(-1, -2)


def cost_matrix(tmpl_masks: torch.Tensor, prop_masks: torch.Tensor,
                tmpl_feats: torch.Tensor, prop_feats: torch.Tensor,
                row_mask: Optional[torch.Tensor] = None,
                col_mask: Optional[torch.Tensor] = None,
                iou_weight: float = 0.3,
                pad_cost: float = 10.0) -> torch.Tensor:
    """lam*(1-IoU) + (1-lam)*(1-cos); padded pairs get ``pad_cost`` (large
    but finite, so exp(-C/eps) underflows cleanly)."""
    iou = mask_iou(tmpl_masks, prop_masks)
    cos = cosine_similarity(tmpl_feats, prop_feats)
    C = iou_weight * (1.0 - iou) + (1.0 - iou_weight) * (1.0 - cos)
    if row_mask is not None and col_mask is not None:
        pair = row_mask[..., :, None] & col_mask[..., None, :]
        C = torch.where(pair, C, torch.full_like(C, pad_cost))
    return C
