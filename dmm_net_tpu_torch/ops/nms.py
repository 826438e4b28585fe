"""Greedy non-maximum suppression with a fixed number of output slots.

Counterpart of the JAX package's ops/nms.py. The selection loop runs
``max_out`` steps whatever the data, and never reads a value back to the
host: each step is a max over the live scores and one row of the
suppression matrix, indexed with the 0-d argmax tensor. Returns
``keep_idx`` (max_out,) int64 padded with -1 and ``keep_mask`` (max_out,)
bool, as the JAX op does.
"""

from __future__ import annotations

from typing import Optional

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (N, 4) and (M, 4) xyxy boxes."""
    area_a = (a[:, 2] - a[:, 0]).clamp_min(0) * (a[:, 3] - a[:, 1]).clamp_min(0)
    area_b = (b[:, 2] - b[:, 0]).clamp_min(0) * (b[:, 3] - b[:, 1]).clamp_min(0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp_min(1e-9)


def _greedy_nms(iou: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                iou_threshold: float, max_out: int):
    """Each step keeps the first maximal live score and kills it and every
    candidate overlapping it by more than ``iou_threshold``. Once every score
    is dead, the remaining steps keep nothing."""
    N = scores.shape[0]
    neg = float("-inf")
    live = torch.where(valid, scores.float(), torch.full_like(scores, neg,
                                                              dtype=torch.float32))
    suppress = (iou > iou_threshold) | torch.eye(N, dtype=torch.bool,
                                                 device=scores.device)
    vals, idxs = [], []
    for _ in range(max_out):
        v, i = live.max(0)                 # first maximal index, as jnp.argmax
        vals.append(v)
        idxs.append(i)
        live = live.masked_fill(suppress.index_select(0, i.view(1))[0], neg)
    keep_mask = torch.stack(vals) > neg
    keep_idx = torch.where(keep_mask, torch.stack(idxs),
                           torch.full_like(keep_mask, -1, dtype=torch.int64))
    return keep_idx, keep_mask


def nms_boxes(boxes: torch.Tensor, scores: torch.Tensor,
              valid: Optional[torch.Tensor] = None,
              iou_threshold: float = 0.5, max_out: int = 100):
    """Greedy box NMS: boxes (N, 4), scores (N,), valid (N,) bool."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    return _greedy_nms(box_iou(boxes, boxes), scores, valid, iou_threshold,
                       max_out)


def nms_masks(mask_iou_matrix: torch.Tensor, scores: torch.Tensor,
              valid: Optional[torch.Tensor] = None,
              iou_threshold: float = 0.5, max_out: int = 100):
    """Greedy NMS on a precomputed (N, N) mask-IoU matrix."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    return _greedy_nms(mask_iou_matrix, scores, valid, iou_threshold, max_out)
