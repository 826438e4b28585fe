"""COCO-style detection and instance-segmentation AP (numpy, host side):
the port's own copy of the JAX package's eval/detection_ap.py, which
imports no JAX; the port keeps a copy so that it imports nothing of that
package.

The protocol follows pycocotools' cocoeval: per-class score-ordered greedy
matching, each gt matched at most once, the 101-point interpolated
precision envelope, AP averaged over IoU thresholds .5:.95:.05 and over the
classes present in the gt. Box IoU and mask IoU (instance segmentation).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# exact cocoeval threshold values — np.arange accumulates float error
# (0.9500000000000003 would reject exact-boundary IoUs linspace accepts)
IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of xyxy boxes a (K,4) vs b (G,4) -> (K, G)."""
    ax1, ay1, ax2, ay2 = a[:, 0:1], a[:, 1:2], a[:, 2:3], a[:, 3:4]
    bx1, by1, bx2, by2 = b[None, :, 0], b[None, :, 1], b[None, :, 2], b[None, :, 3]
    iw = np.clip(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0, None)
    ih = np.clip(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0, None)
    inter = iw * ih
    area_a = np.clip(ax2 - ax1, 0, None) * np.clip(ay2 - ay1, 0, None)
    area_b = np.clip(bx2 - bx1, 0, None) * np.clip(by2 - by1, 0, None)
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


def mask_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of binary masks a (K,H,W) vs b (G,H,W) -> (K, G)."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    af = (a > 0.5).reshape(a.shape[0], -1).astype(np.float64)
    bf = (b > 0.5).reshape(b.shape[0], -1).astype(np.float64)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None] - inter
    return inter / np.maximum(union, 1e-9)


def _ap_from_matches(scores: np.ndarray, tp: np.ndarray,
                     n_gt: int) -> float:
    """101-point interpolated AP given per-detection scores and TP flags."""
    if n_gt == 0:
        return float("nan")
    if scores.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="mergesort")
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(1 - tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
    # precision envelope (monotone non-increasing from the right)
    for i in range(precision.size - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    # 101-point interpolation: precision at first recall >= r
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    p = np.where(idx < precision.size, precision[np.minimum(idx, precision.size - 1)], 0.0)
    return float(p.mean())


def evaluate_detections(
    predictions: Sequence[Dict[str, np.ndarray]],
    ground_truth: Sequence[Dict[str, np.ndarray]],
    iou_type: str = "box",
    iou_thresholds: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """AP over a set of images.

    predictions[i]: dict with "boxes" (K,4), "scores" (K,), "classes"
      (K,), optional "masks" (K,H,W), optional "valid" (K,) bool.
    ground_truth[i]: dict with "boxes" (G,4), "labels" (G,), "valid"
      (G,) bool, optional "masks" (G,H,W).

    Returns {"mAP", "AP50", "AP75", "AR"} (class-mean; NaN-free — classes
    with no GT anywhere are skipped).
    """
    ths = IOU_THRESHOLDS if iou_thresholds is None else np.asarray(iou_thresholds)
    classes = set()
    for gt in ground_truth:
        v = np.asarray(gt["valid"], bool)
        classes.update(int(c) for c in np.asarray(gt["labels"])[v])
    classes = sorted(classes)

    ap = np.zeros((len(classes), len(ths)))
    recall_at = np.zeros((len(classes), len(ths)))
    for ci, cls in enumerate(classes):
        # gather per-image matches at every threshold
        all_scores: List[np.ndarray] = []
        all_tp: List[np.ndarray] = []      # (K, T) per image
        n_gt = 0
        for pred, gt in zip(predictions, ground_truth):
            gv = np.asarray(gt["valid"], bool) & (np.asarray(gt["labels"]) == cls)
            pv = np.asarray(pred.get("valid", np.ones(len(pred["scores"]), bool)), bool)
            pv = pv & (np.asarray(pred["classes"]) == cls)
            n_gt += int(gv.sum())
            scores = np.asarray(pred["scores"])[pv]
            if scores.size == 0:
                continue
            if iou_type == "mask":
                iou = mask_iou_matrix(np.asarray(pred["masks"])[pv],
                                      np.asarray(gt["masks"])[gv])
            else:
                iou = box_iou_matrix(np.asarray(pred["boxes"])[pv],
                                     np.asarray(gt["boxes"])[gv])
            order = np.argsort(-scores, kind="mergesort")
            tp = np.zeros((scores.size, len(ths)))
            for ti, th in enumerate(ths):
                taken = np.zeros(iou.shape[1], bool)
                for k in order:
                    if iou.shape[1] == 0:
                        break
                    j = int(np.argmax(np.where(taken, -1.0, iou[k])))
                    if not taken[j] and iou[k, j] >= th:
                        taken[j] = True
                        tp[k, ti] = 1.0
            all_scores.append(scores)
            all_tp.append(tp)
        scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
        tps = np.concatenate(all_tp) if all_tp else np.zeros((0, len(ths)))
        for ti in range(len(ths)):
            ap[ci, ti] = _ap_from_matches(scores, tps[:, ti], n_gt)
            recall_at[ci, ti] = tps[:, ti].sum() / max(n_gt, 1)

    i50 = int(np.argmin(np.abs(ths - 0.5)))
    i75 = int(np.argmin(np.abs(ths - 0.75)))
    return {
        "mAP": float(np.nanmean(ap)) if ap.size else 0.0,
        "AP50": float(np.nanmean(ap[:, i50])) if ap.size else 0.0,
        "AP75": float(np.nanmean(ap[:, i75])) if ap.size else 0.0,
        "AR": float(np.nanmean(recall_at)) if ap.size else 0.0,
        "num_classes": len(classes),
    }
