"""Proposal-network training losses: the counterpart of the JAX package's
models/proposal/losses.py (maskrcnn-benchmark's RPN and ROI-head losses
with dense, static-shape target assignment).

Targets are assigned for ALL anchors and proposals with one box-IoU matrix
each, with no random minibatch subsampling; positives and negatives are
normalised apart. ``F.binary_cross_entropy_with_logits`` and
``F.cross_entropy`` with ``reduction="none"`` are optax's
``sigmoid_binary_cross_entropy`` and
``softmax_cross_entropy_with_integer_labels``. Mask logits are the port's
(P, C, 28, 28).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from dmm_net_tpu_torch.models.proposal.anchors import encode_boxes
from dmm_net_tpu_torch.ops.nms import box_iou


def smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _valid_iou(boxes: torch.Tensor, gt_boxes: torch.Tensor,
               gt_valid: torch.Tensor) -> torch.Tensor:
    """(N, G) IoU with padded gts at -1."""
    iou = box_iou(boxes, gt_boxes)
    return torch.where(gt_valid[None, :], iou, torch.full_like(iou, -1.0))


def assign_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, pos_thresh: float = 0.7,
                   neg_thresh: float = 0.3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-anchor labels: 1 = positive, 0 = negative, -1 = ignore.

    anchors (A, 4); gt_boxes (G, 4) padded; gt_valid (G,) bool. Returns
    (labels (A,) int64, matched_gt (A,) int64).

    The best anchor of every valid gt is forced positive. Where several gts
    pick one anchor, the last of them in index order decides it, as the
    reference's scatter does on the CPU: a padded gt (whose all -1 IoU
    column picks anchor 0) that follows a valid gt with best anchor 0
    leaves anchor 0 as it was. Computed with a max over gt indices, so the
    result is the same on every device."""
    iou = _valid_iou(anchors, gt_boxes, gt_valid)          # (A, G)
    best_iou, best_gt = iou.max(1)
    labels = torch.where(best_iou >= pos_thresh, 1,
                         torch.where(best_iou < neg_thresh, 0, -1))
    best_anchor = iou.argmax(0)                            # (G,)
    G = gt_boxes.shape[0]
    last = torch.full_like(labels, -1).scatter_reduce(
        0, best_anchor, torch.arange(G, device=labels.device), "amax")
    forced = (last >= 0) & gt_valid[last.clamp_min(0)]
    labels = torch.where(forced, torch.ones_like(labels), labels)
    return labels, best_gt


def rpn_loss(objectness: torch.Tensor, deltas: torch.Tensor,
             anchors: torch.Tensor, gt_boxes: torch.Tensor,
             gt_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """objectness (A,), deltas (A, 4) against padded gts."""
    labels, matched = assign_anchors(anchors, gt_boxes, gt_valid)
    pos, neg = labels == 1, labels == 0
    per = F.binary_cross_entropy_with_logits(objectness, pos.float(),
                                             reduction="none")
    n_pos = pos.sum().clamp_min(1)
    n_neg = neg.sum().clamp_min(1)
    zero = torch.zeros_like(per)
    cls_loss = (torch.where(pos, per, zero).sum() / n_pos
                + torch.where(neg, per, zero).sum() / n_neg) * 0.5
    targets = encode_boxes(gt_boxes[matched], anchors)
    reg = smooth_l1(deltas - targets).sum(-1)
    reg_loss = torch.where(pos, reg, torch.zeros_like(reg)).sum() / n_pos
    return {"rpn_cls": cls_loss, "rpn_reg": reg_loss}


def assign_proposals(proposals: torch.Tensor, prop_valid: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_valid: torch.Tensor, fg_thresh: float = 0.5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-proposal class targets (0 = background) and matched gt index."""
    best_iou, best_gt = _valid_iou(proposals, gt_boxes, gt_valid).max(1)
    cls_t = torch.where((best_iou >= fg_thresh) & prop_valid,
                        gt_labels[best_gt].long(), 0)
    return cls_t, best_gt


def box_head_loss(cls_scores: torch.Tensor, box_deltas: torch.Tensor,
                  proposals: torch.Tensor, prop_valid: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                  gt_valid: torch.Tensor,
                  box_weights=(10.0, 10.0, 5.0, 5.0)) -> Dict[str, torch.Tensor]:
    """cls_scores (P, C), box_deltas (P, C * 4)."""
    P, C = cls_scores.shape
    cls_t, matched = assign_proposals(proposals, prop_valid, gt_boxes,
                                      gt_labels, gt_valid)
    ce = F.cross_entropy(cls_scores, cls_t, reduction="none")
    n_valid = prop_valid.sum().clamp_min(1)
    cls_loss = torch.where(prop_valid, ce, torch.zeros_like(ce)).sum() / n_valid
    fg = (cls_t > 0) & prop_valid
    targets = encode_boxes(gt_boxes[matched], proposals, weights=box_weights)
    sel = box_deltas.reshape(P, C, 4).gather(
        1, cls_t[:, None, None].expand(-1, 1, 4))[:, 0]
    reg = smooth_l1(sel - targets).sum(-1)
    reg_loss = (torch.where(fg, reg, torch.zeros_like(reg)).sum()
                / fg.sum().clamp_min(1))
    return {"box_cls": cls_loss, "box_reg": reg_loss}


def crop_gt_mask(gt_mask: torch.Tensor, box: torch.Tensor,
                 out: int = 28) -> torch.Tensor:
    """Bilinear crop of full-image gt masks (..., H, W) to (..., out, out)
    inside boxes (..., 4): the static-shape form of maskrcnn-benchmark's
    project_masks_on_boxes. Sample i of an axis sits at the centre of cell
    i, clamped to the image."""
    H, W = gt_mask.shape[-2:]
    lead = gt_mask.shape[:-2]
    g = gt_mask.reshape((-1, H, W)).float()
    b = box.reshape(-1, 4).float()
    grid = (torch.arange(out, dtype=torch.float32, device=b.device) + 0.5) / out

    def axis(lo, hi, n):
        pos = (lo[:, None] + grid * (hi - lo).clamp_min(1e-3)[:, None]
               - 0.5).clamp(0, n - 1)
        i0 = torch.floor(pos).long()
        return i0, (i0 + 1).clamp_max(n - 1), pos - i0

    x0, x1, dx = axis(b[:, 0], b[:, 2], W)                  # (P, out)
    y0, y1, dy = axis(b[:, 1], b[:, 3], H)

    def rows(yi):                                            # (P, out, W)
        return g.gather(1, yi[:, :, None].expand(-1, -1, W))

    def cols(r, xi):                                         # (P, out, out)
        return r.gather(2, xi[:, None, :].expand(-1, out, -1))

    r0, r1 = rows(y0), rows(y1)
    top = cols(r0, x0) * (1 - dx)[:, None, :] + cols(r0, x1) * dx[:, None, :]
    bot = cols(r1, x0) * (1 - dx)[:, None, :] + cols(r1, x1) * dx[:, None, :]
    crop = top * (1 - dy)[:, :, None] + bot * dy[:, :, None]
    return crop.reshape(lead + (out, out))


def mask_head_loss(mask_logits: torch.Tensor, proposals: torch.Tensor,
                   cls_t: torch.Tensor, matched: torch.Tensor,
                   gt_masks: torch.Tensor) -> torch.Tensor:
    """mask_logits (P, C, 28, 28); gt_masks (G, H, W). BCE on the target
    class's channel for foreground proposals."""
    P, C, mh, mw = mask_logits.shape
    sel = mask_logits.gather(1, cls_t[:, None, None, None].expand(-1, 1, mh, mw))[:, 0]
    crops = crop_gt_mask(gt_masks[matched], proposals, mh)
    per = F.binary_cross_entropy_with_logits(sel, crops, reduction="none").mean((1, 2))
    fg = cls_t > 0
    return torch.where(fg, per, torch.zeros_like(per)).sum() / fg.sum().clamp_min(1)
